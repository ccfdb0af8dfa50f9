"""The port's CLI (`singa_tpu_torch/main.py`) on the CPU through
`main(argv, device="cpu")` against the JAX package's `main`: `serve
--smoke N` on the same config and workspace (both return 0, serve the
same checkpoint step and print snapshots with the same keys and
counts); training with `--synthetic --steps N --workspace` on
lm_tiny.conf and on a shard-backed copy of mlp.conf, both from the same
step-0 snapshot (`--resume`): both exit 0, each package restores the
other's workspace, and the final params agree; `--phase_profile`'s
device split on the `Time per step` lines; and the exit of what the
port does not have yet (2, naming the ROADMAP.md item: a cluster config
asking for tensor, sequence, pipeline or expert parallelism; `-procsID`
and `-hostfile` run since slice 16, `tests/test_torch_distributed.py`,
and the `pipeline` subcommand since slice 15,
`tests/test_torch_pipeline.py`).  On a
machine without a card the CLI raises rather than running on the
CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import singa_tpu.main as jmain
import singa_tpu.utils.checkpoint as jckpt

import singa_tpu_torch.main as tmain
from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.discovery import discover_input_shapes
from singa_tpu_torch.data.records import Record, SingleLabelImageRecord
from singa_tpu_torch.data.shard import Shard
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
CONF = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "transformer", "lm_tiny.conf")
# the counts that do not depend on timing (cb_steps counts scheduler
# iterations, which do)
COUNTS = ("submitted", "completed", "failed", "generated_tokens",
          "batches", "params_step")


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("spec", [
    "buckets=1x8/2x16,max_new_tokens=4",
    "buckets=2x16,max_new_tokens=4,cb=on,cb_slots=2,cb_block_len=4",
])
def test_serve_smoke_matches_the_jax_cli(spec, tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    net = build_net(load_model_config(CONF), "kTrain",
                    {"data": {"input": (16,), "target": (16,)}})
    CheckpointManager(str(tmp_path)).save(
        3, numpy_params(net, seed=4), {"t": np.zeros((), np.float32)})
    argv = ["serve", "-model_conf", CONF, "--workspace", str(tmp_path),
            "--serve_spec", spec, "--smoke", "3"]
    assert tmain.main(argv, device="cpu") == 0
    got = _last_json(capsys.readouterr().out)
    assert jmain.main(argv) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["params_step"] == 3 and got["completed"] == 3


@pytest.mark.parametrize("argv,item", [
    # a pipe axis beside an expert axis runs (A9 is done): lm.conf under
    # pipe=2 x expert=2 trains, its mesh unused on one process
    (["-model_conf", os.path.join(os.path.dirname(CONF), "lm.conf"),
      "-cluster_conf", "{cluster}", "--synthetic", "--steps", "1",
      "--batchsize", "2"], "A9"),
])
def test_what_the_port_lacks_exits_2_naming_the_roadmap_item(
        argv, item, capsys, tmp_path):
    """Nothing the JAX CLI runs exits 2 in the port any more: the cluster
    config that named ROADMAP.md A9 trains."""
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("pipeline_parallel: 2\nexpert_parallel: 2\n")
    argv = [a.replace("{cluster}", str(cluster)) for a in argv]
    assert tmain.main(argv, device="cpu") == 0
    out = capsys.readouterr()
    assert "training done" in out.out + out.err
    assert f"ROADMAP.md {item}" not in out.out + out.err


def test_lm_conf_under_the_shipped_cluster_conf_trains(capsys):
    """lm.conf's kMoE routes the global batch (A9 step 4), so the shipped
    2 x 2 x 2 cluster.conf no longer refuses it; on one process its mesh
    is not used, as in the JAX CLI (8 processes: chip_smoke.py 22a)."""
    ex = os.path.dirname(CONF)
    assert tmain.main(["-model_conf", os.path.join(ex, "lm.conf"),
                       "-cluster_conf", os.path.join(ex, "cluster.conf"),
                       "--synthetic", "--steps", "1", "--batchsize", "2"],
                      device="cpu") == 0
    out = capsys.readouterr()
    assert "training done" in out.out + out.err


def test_phase_profile_logs_the_device_split(capsys):
    assert tmain.main(["-model_conf", CONF, "--synthetic", "--steps", "4",
                       "--phase_profile"], device="cpu") == 0
    out = capsys.readouterr()
    lines = [line for line in (out.out + out.err).splitlines()
             if "Time per step" in line]
    assert lines and all("[device: fwd" in line and
                         "% of device time attributed]" in line
                         for line in lines)


def _train_series(run, argv, ws):
    """The `singa_train_*` series of the last metrics dump that a CLI run
    with `--obs on` wrote to `ws/obs/events.jsonl`."""
    assert run([*argv, "--workspace", ws, "--obs", "on", "--obs_spec",
                "metrics_period_s=600"]) == 0
    with open(os.path.join(ws, "obs", "events.jsonl")) as f:
        dumps = [e["metrics"] for e in map(json.loads, f)
                 if e.get("kind") == "metrics"]
    return {k: v for k, v in dumps[-1].items()
            if k.startswith("singa_train")}


# the unchunked loop, the synchronous chunked loop (stage apart from
# wait) and the pipeline subcommand's supervised trainer
@pytest.mark.parametrize("argv", [
    ["-model_conf", CONF, "--synthetic", "--steps", "6"],
    ["-model_conf", CONF, "--synthetic", "--steps", "8", "--scan_chunk",
     "4", "--feeder", "off"],
    ["pipeline", "-model_conf", CONF, "--synthetic", "--steps", "8",
     "--smoke", "2", "--serve_spec", "buckets=2x16,max_new_tokens=4",
     "--rollout_spec", "poll_s=0.1,window_s=0.25,min_requests=1"],
], ids=["unchunked", "chunked", "pipeline"])
def test_obs_exports_the_trainer_timer_as_the_jax_cli_does(argv, tmp_path):
    """C13: under `--obs on` the metrics dump holds the trainer's timer,
    `singa_train_steps_total` and a `singa_train_phase_<phase>_seconds_
    total` per phase, under the names the JAX CLI writes on the same
    argv."""
    steps = int(argv[argv.index("--steps") + 1])
    got = _train_series(lambda a: tmain.main(a, device="cpu"), argv,
                        str(tmp_path / "port"))
    assert got["singa_train_steps_total"] >= steps, got
    for phase in ("wait", "stage", "train"):
        assert got[f"singa_train_phase_{phase}_seconds_total"] >= 0, got
    assert got["singa_train_phase_train_seconds_total"] > 0, got
    want = _train_series(jmain.main, argv, str(tmp_path / "jax"))
    assert set(got) == set(want)


def test_the_cli_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-card "
                    "behaviour is checked where there is none")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["serve", "-model_conf", CONF, "--smoke", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["-model_conf", CONF, "--synthetic", "--steps", "1"])


def _mnist_shard_conf(tmp_path) -> str:
    """A shard folder of 64 MNIST-shaped records, and a copy of
    examples/mnist/mlp.conf that reads it."""
    folder = os.path.join(str(tmp_path), "shard")
    os.makedirs(folder)
    rng = np.random.default_rng(6)
    with Shard(folder, Shard.KCREATE) as sh:
        for i in range(64):
            img = rng.integers(0, 256, (28, 28), dtype=np.uint8)
            sh.insert(f"{i:05d}", Record(image=SingleLabelImageRecord(
                shape=[28, 28], label=int(rng.integers(0, 10)),
                pixel=img.tobytes())).encode())
    with open(os.path.join(os.path.dirname(CONF), "..", "mnist",
                           "mlp.conf")) as f:
        text = f.read()
    text = text.replace("batchsize: 1000",
                        f'batchsize: 1000\n      path: "{folder}"', 1)
    out = os.path.join(str(tmp_path), "mlp.conf")
    with open(out, "w") as f:
        f.write(text)
    return out


def _start(conf, ws, synthetic):
    """A step-0 snapshot of numpy-drawn weights in `ws`, for both CLIs
    to `--resume` from."""
    model = load_model_config(conf)
    tr = Trainer(model, discover_input_shapes(model,
                                              force_synthetic=synthetic),
                 device="cpu", log_fn=lambda s: None)
    p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, seed=3),
                          device="cpu")
    CheckpointManager(ws, log_fn=lambda s: None).save(
        0, p, tr.updater.init(p))
    return tr


# (config, argv tail, rtol, atol of the final params): lm_tiny's Adam
# moves a weight whose gradient sits near 0 by up to ~lr when the
# gradient's last bits differ (tests/test_torch_train.py), so atol is
# a fifth of its lr; the MLP's SGD steps stay within f32 rounding
@pytest.mark.parametrize("which", ["lm_tiny", "mlp_shard"])
def test_training_matches_the_jax_cli_and_workspaces_cross(
        which, tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    if which == "lm_tiny":
        conf, tail, synthetic = CONF, ["--synthetic", "--steps", "12",
                                       "--scan_chunk", "4"], True
        rtol, atol = 1e-4, 2e-4
    else:
        conf, tail, synthetic = (_mnist_shard_conf(tmp_path),
                                 ["--steps", "4", "--batchsize", "8"], False)
        rtol, atol = 1e-5, 1e-6
    wss = {k: os.path.join(str(tmp_path), k) for k in ("port", "jax")}
    tr = _start(conf, wss["port"], synthetic)
    shutil.copytree(wss["port"], wss["jax"])
    steps = int(tail[tail.index("--steps") + 1])
    argv = lambda ws: ["-model_conf", conf, "--workspace", ws,  # noqa: E731
                       "--resume", *tail]
    assert tmain.main(argv(wss["port"]), device="cpu") == 0
    assert jmain.main(argv(wss["jax"])) == 0
    got = CheckpointManager(wss["port"]).restore()
    want = jckpt.CheckpointManager(wss["jax"]).restore()
    assert got[2] == want[2] == steps
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], np.asarray(want[0][k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    # each package restores the other's workspace
    p, o = tr.init(0)
    tp, to, tstep = tr.resume(p, o, wss["jax"])
    assert tstep == steps
    np.testing.assert_array_equal(
        tp[sorted(tp)[0]].numpy(), np.asarray(want[0][sorted(tp)[0]]))
    import singa_tpu.main  # noqa: F401  (the JAX trainer, as main runs it)
    from singa_tpu.config import load_model_config as jload
    from singa_tpu.core.trainer import Trainer as JTrainer
    from singa_tpu.data import discover_input_shapes as jdiscover
    jmodel = jload(conf)
    jtr = JTrainer(jmodel, jdiscover(jmodel, force_synthetic=synthetic),
                   log_fn=lambda s: None)
    jp, jo = jtr.init(0)
    jp, jo, jstep = jtr.resume(jp, jo, wss["port"])
    assert jstep == steps
    for k in got[0]:
        np.testing.assert_array_equal(np.asarray(jp[k]), got[0][k])
