"""The port reads the JAX package's orbax workspaces
(`singa_tpu_torch/utils/checkpoint.py`): a workspace that the JAX CLI
and the JAX `CheckpointManager` wrote with orbax on, as they do wherever
`orbax.checkpoint` imports.

Each case holds the port against the JAX package on that workspace:
the steps listed, the state triple restored (equal to the bit to JAX's
own restore: the same stored arrays; bf16 leaves widened to f32, which
holds each exactly), `Trainer.resume`, the CLI's `--resume` and an
`InferenceEngine` taking the step up, the health verdict under the bare
step, the walk-back past a torn step.  Every case runs with
`tensorstore` hidden from `sys.modules`, as on the card's machine, and
on the CPU (`device="cpu"`: the plain zstd decoder); the port reads the
steps with its own OCDBT, zarr and zstd reader.
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import singa_tpu.main as jmain
import singa_tpu.utils.checkpoint as jckpt

import singa_tpu_torch.main as tmain
from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.discovery import discover_input_shapes
from singa_tpu_torch.serve import InferenceEngine, ServeSpec
from singa_tpu_torch.utils import faults
from singa_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              LayoutMismatchError,
                                              OrbaxUnreadableError)

pytestmark = pytest.mark.port
CONF = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "transformer", "lm_tiny.conf")
STEPS = 16      # lm_tiny saves every 8 steps: orbax steps 8 and 16


@pytest.fixture(scope="module")
def jax_ws(tmp_path_factory):
    """A workspace the JAX CLI trained with orbax on (steps 8 and 16,
    health verdicts in the manifest)."""
    assert jckpt._HAVE_ORBAX, "orbax.checkpoint must import for this file"
    ws = str(tmp_path_factory.mktemp("jax_orbax"))
    assert jmain.main(["-model_conf", CONF, "--synthetic", "--steps",
                       str(STEPS), "--workspace", ws]) == 0
    return ws


@pytest.fixture
def ws(jax_ws, tmp_path):
    """A copy of the JAX workspace the test may change."""
    dst = str(tmp_path / "ws")
    shutil.copytree(jax_ws, dst)
    return dst


@pytest.fixture(autouse=True)
def _hide_tensorstore(monkeypatch):
    """An import of tensorstore fails, as where it is not installed (the
    JAX package's orbax keeps the module it bound at its own import)."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)


def _mgr(ws):
    return CheckpointManager(ws, device="cpu")


def _equal_trees(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _equal_trees(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            if w.dtype.name == "bfloat16":
                w = w.astype(np.float32)
            assert got[k].dtype == w.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


def test_steps_are_listed_as_the_jax_manager_lists_them(ws):
    mine, theirs = _mgr(ws), jckpt.CheckpointManager(ws)
    assert mine.available_steps() == theirs.available_steps() == [8, STEPS]
    assert mine.latest_step() == theirs.latest_step() == STEPS
    for s in (8, STEPS):
        assert mine.health_verdict(s) == theirs.health_verdict(s) == "ok"


def test_restore_equals_the_jax_restore_adam_history_and_step(ws):
    mine, theirs = _mgr(ws), jckpt.CheckpointManager(ws)
    for step in (None, 8):
        p, o, s = mine.restore(step)
        jp, jo, js = theirs.restore(step)
        assert s == js == (step or STEPS)
        _equal_trees(p, jp)
        _equal_trees(o, jo)
        assert len(o) >= 2    # Adam's two moments, at least


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_leaves_come_back_widened_and_exact(tmp_path, dtype):
    rng = np.random.default_rng(3)
    params = {"fc/w": jnp.asarray(rng.standard_normal((4, 5)), dtype),
              "fc/b": jnp.asarray(rng.standard_normal(5), dtype)}
    opt = {"history": {k: v * 0.5 for k, v in params.items()}}
    jckpt.CheckpointManager(str(tmp_path)).save(5, params, opt)
    p, o, s = _mgr(str(tmp_path)).restore()
    assert s == 5
    _equal_trees(p, params)
    _equal_trees(o, opt)
    assert all(v.dtype == np.float32 for v in p.values())


def test_trainer_resume_takes_up_the_orbax_step(ws):
    model = load_model_config(CONF)
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 log_fn=lambda s: None, device="cpu")
    p0, o0 = tr.init(seed=0)
    p, o, step = tr.resume(p0, o0, ws)
    assert step == STEPS
    jp, jo, _ = jckpt.CheckpointManager(ws).restore()
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), k)
    for slot in jo:
        for k in jo[slot]:
            np.testing.assert_array_equal(o[slot][k].numpy(),
                                          np.asarray(jo[slot][k]))


def test_cli_resume_trains_on_and_restores_the_newest_of_either_kind(
        ws, capsys):
    argv = ["-model_conf", CONF, "--synthetic", "--steps", str(STEPS + 4),
            "--workspace", ws, "--resume"]
    assert tmain.main(argv, device="cpu") == 0
    out = capsys.readouterr()
    assert f"resumed from step {STEPS}" in out.out + out.err
    mgr = _mgr(ws)
    # the port writes npz beside the orbax steps; the newest wins
    assert mgr.available_steps() == [8, STEPS, STEPS + 4]
    assert os.path.exists(os.path.join(mgr.dir, f"step_{STEPS + 4}.npz"))
    assert mgr.restore()[2] == STEPS + 4
    assert mgr.restore(STEPS + 3)[2] == STEPS


def test_an_engine_serves_the_orbax_step(ws):
    model = load_model_config(CONF)
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 log_fn=lambda s: None, device="cpu", graphs=False)
    net = tr.test_net or tr.train_net
    eng = InferenceEngine(net, ServeSpec.parse("buckets=2x16,max_new_tokens=2"),
                          net.init_params(0, device="cpu"), device="cpu",
                          workspace=ws, log_fn=lambda s: None)
    assert eng.load() == STEPS
    jp = jckpt.CheckpointManager(ws).restore()[0]
    for k in jp:
        np.testing.assert_array_equal(eng._params[k].numpy(),
                                      np.asarray(jp[k]), k)


def test_a_spike_verdict_is_skipped_and_a_new_save_moves_the_fingerprint(
        ws):
    mine = _mgr(ws)
    fp = mine.fingerprint()
    p, o, _ = jckpt.CheckpointManager(ws).restore()
    jckpt.CheckpointManager(ws).save(STEPS + 8, p, o,
                                     health={"verdict": "spike"})
    assert mine.fingerprint() != fp
    assert mine.health_verdict(STEPS + 8) == "spike"
    assert not mine.save_in_flight()
    assert mine.restore()[2] == STEPS + 8
    assert mine.restore(skip_unhealthy=True)[2] == STEPS


def test_a_torn_orbax_step_is_walked_past(ws, capsys):
    mine = _mgr(ws)
    jckpt._tear(os.path.join(mine.dir, str(STEPS)))
    with faults.inject(None):
        assert mine.restore()[2] == 8
    assert f"checkpoint step {STEPS} is corrupt" in capsys.readouterr().out


def test_a_torn_orbax_metadata_is_walked_past(ws, capsys):
    mine = _mgr(ws)
    meta = os.path.join(mine.dir, str(STEPS), "default", "_METADATA")
    with open(meta, "r+b") as f:
        f.truncate(os.path.getsize(meta) // 2)
    assert mine.restore()[2] == 8
    assert f"checkpoint step {STEPS} is corrupt" in capsys.readouterr().out


@pytest.mark.parametrize("change", ["sequence_key", "scalar_value",
                                    "no_tree", "no_step"])
def test_an_orbax_tree_it_does_not_understand_is_refused_by_name(
        ws, capsys, change):
    """A step whose metadata is whole but describes what the reader does
    not handle is never walked past: `restore` raises, and the CLI exits
    1 with the reason instead of resuming from an older step."""
    mgr = _mgr(ws)
    meta = os.path.join(mgr.dir, str(STEPS), "default", "_METADATA")
    with open(meta) as f:
        doc = json.load(f)
    tree = doc["tree_metadata"]
    if change == "no_tree":
        del doc["tree_metadata"]
    elif change == "no_step":
        del tree[next(k for k in tree if "'step'" in k)]
    else:
        entry = next(iter(tree.values()))
        if change == "sequence_key":
            entry["key_metadata"][-1]["key_type"] = 1
        else:
            entry["value_metadata"]["value_type"] = "scalar"
    with open(meta, "w") as f:
        json.dump(doc, f)
    with pytest.raises(OrbaxUnreadableError, match="does not understand"):
        mgr.restore()
    assert mgr.restore(8)[2] == 8       # the older step still reads
    capsys.readouterr()
    argv = ["-model_conf", CONF, "--synthetic", "--steps", str(STEPS + 4),
            "--workspace", ws, "--resume"]
    assert tmain.main(argv, device="cpu") == 1
    out = capsys.readouterr()
    assert "does not understand" in out.err
    assert "resumed from" not in out.out + out.err
    assert "training done" not in out.out + out.err


def test_the_layout_version_is_checked_on_orbax_steps(ws):
    with open(os.path.join(ws, "checkpoints", "LAYOUT_VERSION"), "w") as f:
        f.write("1")
    with pytest.raises(LayoutMismatchError):
        _mgr(ws).restore()


def test_without_tensorstore_the_workspace_is_never_skipped(
        ws, monkeypatch, capsys):
    """Where tensorstore cannot be imported (the card's machine), the
    orbax step restores equal to the JAX restore, and `--resume` through
    the CLI takes it up and trains on."""
    with pytest.raises(ImportError):
        import tensorstore  # noqa: F401
    mgr = _mgr(ws)
    assert mgr.available_steps() == [8, STEPS]
    mgr.fingerprint()
    assert mgr.latest_step() == STEPS
    p, o, s = mgr.restore()
    jp, jo, js = jckpt.CheckpointManager(ws).restore()
    assert s == js == STEPS
    _equal_trees(p, jp)
    _equal_trees(o, jo)
    capsys.readouterr()
    argv = ["-model_conf", CONF, "--synthetic", "--steps", str(STEPS + 4),
            "--workspace", ws, "--resume"]
    assert tmain.main(argv, device="cpu") == 0
    out = capsys.readouterr()
    text = out.out + out.err
    assert f"resumed from step {STEPS}" in text
    assert "starting from scratch" not in text
    assert "training done" in text
    assert mgr.available_steps() == [8, STEPS, STEPS + 4]
    assert tmain.main(["serve", "-model_conf", CONF, "--workspace", ws,
                       "--serve_spec", "buckets=2x16,max_new_tokens=2",
                       "--smoke", "1"], device="cpu") == 0


def test_a_step_in_both_kinds_reads_the_npz(ws):
    """The port's own npz of a step wins over an orbax directory of the
    same step."""
    mgr = _mgr(ws)
    p, o, _ = mgr.restore(8)
    p = {k: v + 1.0 for k, v in p.items()}
    mgr.save(8, p, o)
    got = mgr.restore(8)[0]
    for k in p:
        np.testing.assert_array_equal(got[k], p[k])
    assert torch.from_numpy(got[next(iter(got))]).dtype == torch.float32
