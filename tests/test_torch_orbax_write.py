"""The port writes orbax steps where a workspace's newest step is orbax
(`singa_tpu_torch/utils/checkpoint.py` `_write_orbax`, over
`utils/ocdbt.py`'s `OcdbtWriter`, `utils/zarr.py`'s `v2_entries` and
`utils/zstd.py`'s frames of Raw blocks), so a run moved from the TPU to
the card and back resumes from the card's last step.

Each case starts from a copy of a committed fixture
(`tests/torch_fixtures/orbax/{lm_tiny,conv}`: the JAX CLI's orbax steps
of `lm_tiny.conf` and `conv.conf`) and holds what the port writes into
it against the JAX package's orbax and tensorstore: the JAX
`CheckpointManager` lists each step and restores it bit-equal,
templateless and with the JAX trainer's own tree as template (what its
CLI passes); tensorstore reads every leaf; the JAX CLI's `--resume`
trains on from it; the port's plain reader restores it bit-equal.  Then
the writer's faults: a writer cut before `_CHECKPOINT_METADATA`, the
`torn` kind, the retention of 3 steps, a re-save, and npz in a fresh
workspace.
"""

import json
import os
import shutil

import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

import singa_tpu.main as jmain
import singa_tpu.utils.checkpoint as jckpt

import singa_tpu_torch.utils.checkpoint as tckpt
from singa_tpu_torch.utils import faults, zstd
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.utils.ocdbt import (MAX_INLINE_VALUE_BYTES, OcdbtStore,
                                         OcdbtWriter)

pytestmark = pytest.mark.port
HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "torch_fixtures", "orbax")
EXAMPLES = os.path.join(HERE, "..", "examples")
CONFS = {"lm_tiny": os.path.join(EXAMPLES, "transformer", "lm_tiny.conf"),
         "conv": os.path.join(EXAMPLES, "mnist", "conv.conf")}
FIXTURE_STEP = {"lm_tiny": 8, "conv": 4}


def _copy(tmp_path, name):
    ws = str(tmp_path / name)
    shutil.copytree(os.path.join(FIXTURES, name), ws)
    return ws


def _mgr(ws):
    return CheckpointManager(ws, device="cpu", log_fn=lambda s: None)


def _state(ws, shift):
    """The workspace's newest state (as the JAX package restores it) as
    the port's trainer holds it, tensors, moved by `shift` so a step
    written from it differs from the fixture's."""
    p, o, _ = jckpt.CheckpointManager(ws, log_fn=lambda s: None).restore()
    return ({k: torch.from_numpy(np.asarray(v) + shift)
             for k, v in p.items()},
            {s: {k: torch.from_numpy(np.asarray(v) * 0.5 + shift)
                 for k, v in d.items()} for s, d in o.items()})


def _equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _equal(got[k], want[k], f"{path}/{k}")
            continue
        w = want[k]
        w = w.float().numpy() if isinstance(w, torch.Tensor) else \
            np.asarray(w)
        g = np.asarray(got[k])
        if g.dtype.name == "bfloat16":
            g = g.astype(np.float32)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _jax_template(name):
    """The tree the JAX CLI passes to `restore` on `--resume`: its
    trainer's own params and optimizer state."""
    import singa_tpu.main  # noqa: F401  (the JAX trainer, as main runs it)
    from singa_tpu.config import load_model_config as jload
    from singa_tpu.core.trainer import Trainer as JTrainer
    from singa_tpu.data import discover_input_shapes as jdiscover
    model = jload(CONFS[name])
    tr = JTrainer(model, jdiscover(model, force_synthetic=True),
                  log_fn=lambda s: None)
    p, o = tr.init(0)
    return {"params": p, "opt_state": o}


def _tensorstore_leaf(ws, step, path):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt",
                        "base": f"file://{ws}/checkpoints/{step}/default/",
                        "path": f"{path}/"}}
    return ts.open(spec, open=True, read=True).result().read().result()


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 131072,
                                  131073, 300000])
def test_raw_frames_decode_in_libzstd_and_both_decoders(size):
    """A frame of Raw blocks across the header's size fields and the
    128 KiB block boundary."""
    data = np.random.default_rng(size).integers(0, 256, size,
                                                np.uint8).tobytes()
    frame = b"".join(zstd.raw_frame(data))
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.get_frame_parameters(frame).content_size == size
    assert zstd.decompress(frame) == data
    assert zstd.content_size(frame) == size


def test_an_ocdbt_database_reads_alike_in_tensorstore_and_the_port(
        tmp_path):
    """Values up to `max_inline_value_bytes` inline in the leaf node, the
    rest in the data file; keys that share prefixes."""
    rng = np.random.default_rng(0)
    values = {k: rng.integers(0, 256, n, np.uint8).tobytes()
              for k, n in (("a/.zarray", 10), ("a/0", 5000), ("ab/0", 0),
                           ("b", MAX_INLINE_VALUE_BYTES),
                           ("c", MAX_INLINE_VALUE_BYTES + 1))}
    root = str(tmp_path / "db")
    w = OcdbtWriter(root)
    for k, v in values.items():
        w.put(k, [v[:3], v[3:]])
    w.close()
    store = OcdbtStore(root, zstd.Codec(native=False))
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    assert [k.decode() for k in kv.list().result()] == store.list() == \
        sorted(values)
    for k, v in values.items():
        assert store.read(k) == kv.read(k).result().value == v, k
        assert isinstance(store._entries[k], bytes) == (
            len(v) <= MAX_INLINE_VALUE_BYTES), k


@pytest.mark.parametrize("name", ["lm_tiny", "conv"])
def test_the_jax_package_lists_and_restores_each_step_bit_equal(
        name, tmp_path):
    ws = _copy(tmp_path, name)
    first = FIXTURE_STEP[name]
    p, o = _state(ws, 1.0)
    mgr = _mgr(ws)
    mgr.save(first + 1, p, o, health={"verdict": "ok"})
    p2, o2 = _state(ws, 2.0)
    mgr.save(first + 2, p2, o2)
    steps = [first, first + 1, first + 2]
    assert mgr.available_steps() == steps
    assert not [f for f in os.listdir(mgr.dir) if f.endswith(".npz")]
    theirs = jckpt.CheckpointManager(ws, log_fn=lambda s: None)
    assert theirs.available_steps() == steps
    assert theirs.health_verdict(first + 1) == mgr.health_verdict(
        first + 1) == "ok"
    jp, jo, js = theirs.restore()
    assert js == first + 2
    _equal(jp, p2)
    _equal(jo, o2)
    tp, to, ts_ = theirs.restore(template=_jax_template(name))
    assert ts_ == first + 2
    _equal(tp, p2)
    _equal(to, o2)
    got = mgr.restore(first + 1)
    assert got[2] == first + 1
    _equal(got[0], p)
    _equal(got[1], o)
    for k, v in p2.items():
        np.testing.assert_array_equal(
            _tensorstore_leaf(ws, first + 2, f"params.{k}"), v.numpy(), k)
    for slot, d in o2.items():
        for k, v in d.items():
            np.testing.assert_array_equal(_tensorstore_leaf(
                ws, first + 2, f"opt_state.{slot}.{k}"), v.numpy(), k)
    assert int(_tensorstore_leaf(ws, first + 2, "step")) == first + 2


def test_bf16_leaves_stay_bfloat16(tmp_path):
    ws = _copy(tmp_path, "conv")
    p, o = _state(ws, 0.25)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    _mgr(ws).save(5, p, o)
    with open(os.path.join(ws, "checkpoints", "5", "default",
                           "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    assert tree["('params', 'ip1/weight')"]["value_metadata"][
        "value_type"] == "jax.Array"
    assert tree["('step',)"]["value_metadata"]["value_type"] == "np.ndarray"
    leaf = _tensorstore_leaf(ws, 5, "params.ip1/weight")
    assert leaf.dtype.name == "bfloat16"
    jp = jckpt.CheckpointManager(ws, log_fn=lambda s: None).restore()[0]
    assert np.asarray(jp["ip1/weight"]).dtype.name == "bfloat16"
    _equal(jp, p)
    got = _mgr(ws).restore()[0]
    assert got["ip1/weight"].dtype == np.float32     # widened, exact
    _equal(got, p)


def test_the_jax_cli_resumes_from_a_port_step(tmp_path, capsys):
    ws = _copy(tmp_path, "lm_tiny")
    p, o = _state(ws, 0.0)
    _mgr(ws).save(9, p, o)
    argv = ["-model_conf", CONFS["lm_tiny"], "--synthetic", "--steps",
            "11", "--workspace", ws, "--resume"]
    assert jmain.main(argv) == 0
    out = capsys.readouterr()
    assert "resumed from step 9" in out.out + out.err
    assert jckpt.CheckpointManager(
        ws, log_fn=lambda s: None).available_steps() == [8, 9, 11]


def test_a_writer_cut_before_the_metadata_leaves_no_step(tmp_path,
                                                         monkeypatch):
    ws = _copy(tmp_path, "lm_tiny")
    p, o = _state(ws, 1.0)
    mgr = _mgr(ws)

    def killed(*a, **k):
        raise KeyboardInterrupt("killed")
    atomic = tckpt._atomic_write

    def killed_at_the_metadata(path, data):
        if path.endswith("_CHECKPOINT_METADATA"):
            killed()
        atomic(path, data)
    # cut while the step is written, then after its rename
    for where, fn in (("_write_orbax", killed),
                      ("_atomic_write", killed_at_the_metadata)):
        with monkeypatch.context() as m:
            m.setattr(tckpt, where, fn)
            with pytest.raises(KeyboardInterrupt):
                mgr.save(9, p, o)
        assert mgr.available_steps() == [8]
        assert jckpt.CheckpointManager(
            ws, log_fn=lambda s: None).available_steps() == [8]
        assert mgr.restore()[2] == 8
    # the wreck of the second cut (a step directory with no metadata) is
    # cleared by the next save of that step
    assert os.path.isdir(os.path.join(mgr.dir, "9"))
    mgr.save(9, p, o)
    assert mgr.available_steps() == [8, 9]
    _equal(mgr.restore()[0], p)


def test_a_torn_save_is_walked_past(tmp_path):
    ws = _copy(tmp_path, "lm_tiny")
    p, o = _state(ws, 1.0)
    logs = []
    mgr = CheckpointManager(ws, device="cpu", log_fn=logs.append)
    with faults.inject(faults.FaultSchedule.parse("ckpt.save@0:torn")):
        mgr.save(9, p, o, health={"verdict": "ok"})
    assert mgr.available_steps() == [8, 9]
    assert mgr.health_verdict(9) is None
    assert mgr.restore()[2] == 8
    assert any("checkpoint step 9 is corrupt" in line for line in logs)
    theirs = jckpt.CheckpointManager(ws, log_fn=lambda s: None)
    assert theirs.available_steps() == [8, 9]
    assert theirs.restore()[2] == 8


def test_four_saves_keep_the_steps_the_jax_manager_keeps(tmp_path):
    ws, jws = _copy(tmp_path, "conv"), str(tmp_path / "jax")
    shutil.copytree(ws, jws)
    p, o = _state(ws, 1.0)
    mgr, theirs = _mgr(ws), jckpt.CheckpointManager(jws,
                                                    log_fn=lambda s: None)
    for step in range(5, 9):
        mgr.save(step, p, o)
        theirs.save(step, {k: v.numpy() for k, v in p.items()},
                    {s: {k: v.numpy() for k, v in d.items()}
                     for s, d in o.items()})
    assert mgr.available_steps() == theirs.available_steps() == [6, 7, 8]
    assert jckpt.CheckpointManager(
        ws, log_fn=lambda s: None).available_steps() == [6, 7, 8]
    assert sorted(os.listdir(mgr.dir)) == sorted(os.listdir(theirs.dir))


def test_a_resave_of_an_orbax_step_replaces_it(tmp_path):
    ws = _copy(tmp_path, "conv")
    mgr = _mgr(ws)
    for shift in (1.0, 3.0):
        p, o = _state(ws, shift) if shift == 1.0 else (
            {k: v + 2.0 for k, v in p.items()}, o)
        mgr.save(5, p, o, health={"verdict": "spike"} if shift == 1.0
                 else None)
    assert mgr.available_steps() == [4, 5]
    assert mgr.health_verdict(5) is None
    _equal(mgr.restore()[0], p)
    _equal(jckpt.CheckpointManager(
        ws, log_fn=lambda s: None).restore()[0], p)
    assert not [f for f in os.listdir(mgr.dir) if f.startswith(".")]


def test_npz_stays_the_default_in_a_fresh_workspace(tmp_path):
    ws = _copy(tmp_path, "conv")
    p, o = _state(ws, 0.0)
    fresh = _mgr(str(tmp_path / "fresh"))
    fresh.save(3, p, o)
    fresh.save(4, p, o)
    assert sorted(os.listdir(fresh.dir)) == [
        "LAYOUT_VERSION", "MANIFEST.json", "step_3.npz", "step_4.npz"]
    assert fresh.restore()[2] == 4
