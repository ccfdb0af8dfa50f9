"""The port's `Supervisor` (`singa_tpu_torch/core/supervisor.py`) and the
Trainer's fault sites on the CPU, against the JAX package's: the
scenarios of `tests/test_faults.py` and `tests/test_health.py` — a
preemption with a torn checkpoint, a transient error with backoff, an
exhausted budget, no workspace, blamed batches with the LR backoff, a
divergence rescue on the chunked loop, an isolated user hook, and the
signal handlers restored after a failure.

Both packages start from the same weights, drawn with numpy
(`weights.numpy_params`) and handed to each trainer's `init`, and read
the same synthetic stream.  Each supervised port run must equal the
port's uninterrupted run (or the manual baseline that makes the same
rescue decisions) under `torch.equal`, and the JAX Supervisor's result
within rtol 1e-5 (atol 1e-7 for weights near 0): the same f32 SGD
steps, whose matmuls sum in another order."""

import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import model_config_from_dict as jcfg_from
from singa_tpu.core.supervisor import Supervisor as JSupervisor
from singa_tpu.core.supervisor import TrainingAborted as JAborted
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.data.synthetic import synthetic_image_batches as jbatches
from singa_tpu.utils import checkpoint as jckpt
from singa_tpu.utils import faults as jfaults
from singa_tpu.utils.health import HealthMonitor as JMonitor

from singa_tpu_torch.config import model_config_from_dict
from singa_tpu_torch.core.supervisor import Supervisor, TrainingAborted
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data import synthetic_image_batches
from singa_tpu_torch.utils.faults import (Backoff, FaultError,
                                          FaultSchedule, FaultSpec, inject)
from singa_tpu_torch.utils.health import HealthMonitor
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

SHAPES = {"data": {"pixel": (28, 28), "label": ()}}
NO_WAIT = Backoff(base=0.0, cap=0.0, jitter=0.0)
RTOL, ATOL = 1e-5, 1e-7


def mlp(train_steps=12, ckpt_freq=4):
    """The MLP of the JAX fault and health tests, as a config dict."""
    return {
        "name": "faults-mlp", "train_steps": train_steps,
        "checkpoint_frequency": ckpt_freq,
        "updater": {"type": "kSGD", "base_learning_rate": 0.01,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": [
            {"name": "data", "type": "kShardData",
             "data_param": {"batchsize": 8}},
            {"name": "mnist", "type": "kMnistImage", "srclayers": "data",
             "mnist_param": {"norm_a": 255.0}},
            {"name": "label", "type": "kLabel", "srclayers": "data"},
            {"name": "ip1", "type": "kInnerProduct", "srclayers": "mnist",
             "inner_product_param": {"num_output": 16},
             "param": [{"name": "w1",
                        "init_method": "kUniformSqrtFanIn"},
                       {"name": "b1"}]},
            {"name": "ip2", "type": "kInnerProduct", "srclayers": "ip1",
             "inner_product_param": {"num_output": 10},
             "param": [{"name": "w2",
                        "init_method": "kUniformSqrtFanIn"},
                       {"name": "b2"}]},
            {"name": "loss", "type": "kSoftmaxLoss",
             "srclayers": ["ip2", "label"]}]}}


def data():
    return synthetic_image_batches(8, seed=3, stream_seed=104)


def jdata():
    return jbatches(8, seed=3, stream_seed=104)


def port_trainer(cfg, health=None, log=None):
    """A CPU port Trainer whose `init` gives the numpy-drawn weights."""
    tr = Trainer(model_config_from_dict(cfg), SHAPES, device="cpu",
                 log_fn=log or (lambda s: None), health=health)
    arrays = numpy_params(tr.train_net, seed=0)

    def init(seed=0):
        p = params_from_numpy(tr.train_net, arrays, device="cpu")
        return p, tr.updater.init(p)
    tr.init = init
    return tr


def jax_trainer(cfg, health=None, log=None):
    """The JAX Trainer on the same config and the same weights."""
    tr = JTrainer(jcfg_from(cfg), SHAPES, log_fn=log or (lambda s: None),
                  donate=False, health=health)
    arrays = numpy_params(port_trainer(cfg).train_net, seed=0)

    def init(seed=0):
        p = {k: jnp.asarray(v) for k, v in arrays.items()}
        return p, tr.updater.init(p)
    tr.init = init
    return tr


def uninterrupted(cfg):
    tr = port_trainer(cfg)
    p, o = tr.init()
    return tr.run(p, o, data(), seed=0)[0]


def assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.isfinite(want[k]).all(), k
        assert torch.equal(got[k], want[k]), k


def assert_close_jax(got, jwant):
    assert set(got) == set(jwant)
    for k in jwant:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jwant[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def jax_supervised(monkeypatch, cfg, schedule, ws, health=None, **kw):
    """The JAX Supervisor's (params, failure kinds) on the same run."""
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    sup = JSupervisor(jax_trainer(cfg, health=health), ws, log=lambda s: None,
                      **kw)
    with jfaults.inject(jfaults.FaultSchedule.parse(schedule)
                        if isinstance(schedule, str) else schedule):
        p = sup.run(jdata, seed=0)[0]
    return p, [f.kind for f in sup.failures]


def test_preemption_with_a_torn_checkpoint_resumes_the_last_valid(
        tmp_path, monkeypatch):
    """Cadence saves at 4, 8 (torn) and 12; a preemption at step 10
    resumes from step 4, past the torn snapshot."""
    want = uninterrupted(mlp())
    logs = []
    sup = Supervisor(port_trainer(mlp(), log=logs.append),
                     str(tmp_path / "t"), max_restarts=2, backoff=NO_WAIT,
                     log=logs.append)
    sched = FaultSchedule([FaultSpec("ckpt.save", 1, "torn"),
                           FaultSpec("step.train", 10, "preempt")])
    with inject(sched):
        got = sup.run(data, seed=0)[0]
    assert_equal(got, want)
    assert [f.kind for f in sup.failures] == ["preemption"]
    assert any("resumed from step 4" in l for l in logs), logs
    assert any("corrupt or partial" in l for l in logs), logs
    assert sorted(f.site for f in sched.fired) == ["ckpt.save",
                                                   "step.train"]
    jp, kinds = jax_supervised(
        monkeypatch, mlp(), "ckpt.save@1:torn,step.train@10:preempt",
        str(tmp_path / "j"), max_restarts=2, backoff=NO_WAIT)
    assert kinds == ["preemption"]
    assert_close_jax(got, jp)


def test_transient_error_backs_off_and_recovers(tmp_path, monkeypatch):
    cfg = mlp(train_steps=6, ckpt_freq=2)
    want = uninterrupted(cfg)
    sup = Supervisor(port_trainer(cfg), str(tmp_path / "t"),
                     max_restarts=2,
                     backoff=Backoff(base=0.01, cap=0.02, seed=1),
                     log=lambda s: None)
    t0 = time.monotonic()
    with inject(FaultSchedule([FaultSpec("step.train", 3, "error")])):
        got = sup.run(data, seed=0)[0]
    assert time.monotonic() - t0 >= 0.01        # the backoff slept
    assert_equal(got, want)
    assert [f.kind for f in sup.failures] == ["error"]
    jp, kinds = jax_supervised(monkeypatch, cfg, "step.train@3:error",
                               str(tmp_path / "j"), max_restarts=2,
                               backoff=NO_WAIT)
    assert kinds == ["error"]
    assert_close_jax(got, jp)


def test_an_exhausted_budget_raises_with_the_jax_failure_kinds(
        tmp_path, monkeypatch):
    cfg = mlp(train_steps=4, ckpt_freq=2)
    sup = Supervisor(port_trainer(cfg), str(tmp_path / "t"), max_restarts=2,
                     backoff=NO_WAIT, log=lambda s: None)
    with inject(FaultSchedule(rates={"step.train": 1.0}, seed=0)), \
            pytest.raises(TrainingAborted) as ei:
        sup.run(data, seed=0)
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    jsup = JSupervisor(jax_trainer(cfg), str(tmp_path / "j"),
                       max_restarts=2, backoff=NO_WAIT, log=lambda s: None)
    with jfaults.inject(jfaults.FaultSchedule(rates={"step.train": 1.0},
                                              seed=0)), \
            pytest.raises(JAborted) as jei:
        jsup.run(jdata, seed=0)
    got = [(f.attempt, f.kind, f.last_step) for f in ei.value.failures]
    assert got == [(f.attempt, f.kind, f.last_step)
                   for f in jei.value.failures]
    assert [k for _, k, _ in got] == ["error"] * 3   # first try + 2
    assert "restart budget" in str(ei.value)
    assert "attempt 1" in str(ei.value)


def test_without_a_workspace_every_attempt_replays_from_zero(monkeypatch):
    cfg = mlp(train_steps=4, ckpt_freq=0)
    want = uninterrupted(cfg)
    logs = []
    sup = Supervisor(port_trainer(cfg), workspace=None, max_restarts=1,
                     backoff=NO_WAIT, log=logs.append)
    with inject(FaultSchedule([FaultSpec("step.train", 2, "error")])):
        got = sup.run(data, seed=0)[0]
    assert_equal(got, want)
    assert any("no workspace" in l for l in logs)
    jp, kinds = jax_supervised(monkeypatch, cfg, "step.train@2:error", None,
                               max_restarts=1, backoff=NO_WAIT)
    assert kinds == ["error"]
    assert_close_jax(got, jp)


def test_blamed_batches_and_the_lr_backoff_equal_a_manual_baseline(
        tmp_path, monkeypatch):
    """nan at step 13: roll back to the step-12 snapshot, drop stream
    batches 13 and 14, halve the learning rate; a plain run making the
    same decisions lands on the same params."""
    cfg = mlp(train_steps=20, ckpt_freq=4)
    tr = port_trainer(cfg, health=HealthMonitor(log_fn=lambda s: None))
    logs = []
    sup = Supervisor(tr, str(tmp_path / "t"), max_restarts=0,
                     backoff=NO_WAIT, blame_batches=2, lr_backoff=0.5,
                     log=logs.append)
    with inject(FaultSchedule.parse("step.grad@13:nan")):
        got = sup.run(data, seed=0)[0]
    assert tr.updater.lr_scale == 0.5
    assert [f.kind for f in sup.failures] == ["divergence"]
    assert any("blaming batches [13, 15)" in l for l in logs), logs

    tr_a = port_trainer(mlp(12, ckpt_freq=0))
    p, o = tr_a.init()
    p12, o12, _ = tr_a.run(p, o, data(), seed=0)
    tr_b = port_trainer(mlp(20, ckpt_freq=0))
    tr_b.updater.lr_scale = 0.5

    def skipping():
        for i, b in enumerate(data()):
            if i not in (13, 14):
                yield b
    it = skipping()
    for _ in range(12):
        next(it)
    want = tr_b.run(p12, o12, it, seed=0, start_step=12)[0]
    assert_equal(got, want)
    jp, kinds = jax_supervised(
        monkeypatch, cfg, "step.grad@13:nan", str(tmp_path / "j"),
        health=JMonitor(log_fn=lambda s: None), max_restarts=0,
        backoff=NO_WAIT, blame_batches=2, lr_backoff=0.5)
    assert kinds == ["divergence"]
    assert_close_jax(got, jp)


def test_a_rescue_on_the_chunked_loop_lands_on_the_uninterrupted_run(
        tmp_path, monkeypatch):
    cfg = mlp(train_steps=20, ckpt_freq=4)
    want = uninterrupted(mlp(20, ckpt_freq=0))
    tr = port_trainer(cfg, health=HealthMonitor(log_fn=lambda s: None))
    sup = Supervisor(tr, str(tmp_path / "t"), max_restarts=0,
                     backoff=NO_WAIT, log=lambda s: None)
    with inject(FaultSchedule.parse("step.grad@13:nan")):
        got = sup.run(data, seed=0, scan_chunk=5)[0]
    assert [f.kind for f in sup.failures] == ["divergence"]
    assert_equal(got, want)
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    jsup = JSupervisor(jax_trainer(cfg, health=JMonitor(log_fn=lambda s: 0)),
                       str(tmp_path / "j"), max_restarts=0,
                       backoff=NO_WAIT, log=lambda s: None)
    with jfaults.inject(jfaults.FaultSchedule.parse("step.grad@13:nan")):
        jp = jsup.run(jdata, seed=0, scan_chunk=5, feeder=False)[0]
    assert [f.kind for f in jsup.failures] == ["divergence"]
    assert_close_jax(got, jp)


def test_a_raising_user_hook_burns_no_restart(tmp_path):
    cfg = mlp(train_steps=6, ckpt_freq=2)
    logs = []
    sup = Supervisor(port_trainer(cfg, log=logs.append), str(tmp_path),
                     max_restarts=0, backoff=NO_WAIT, log=logs.append)
    seen = []

    def bad_hook(step, metrics):
        if step == 2:
            raise RuntimeError("observer bug")
        seen.append(step)

    got = sup.run(data, seed=0, hooks=[bad_hook])[0]
    assert sup.failures == []
    assert seen == [0, 1, 3, 4, 5]
    assert any("user hook" in l and "observer bug" in l for l in logs)
    assert_equal(got, uninterrupted(cfg))


def test_signal_handlers_are_restored_after_a_mid_loop_failure(tmp_path):
    tr = port_trainer(mlp(train_steps=6, ckpt_freq=2))
    p, o = tr.init()
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    with inject(FaultSchedule([FaultSpec("step.train", 1, "error")])):
        with pytest.raises(FaultError):
            tr.run(p, o, data(), seed=0, workspace=str(tmp_path))
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_sigterm_saves_at_the_current_step_and_returns(tmp_path):
    """A SIGTERM during training (here from a hook, at step 2) saves a
    snapshot at the next step boundary and returns; resuming from it
    finishes on the uninterrupted trajectory."""
    import os
    cfg = mlp(train_steps=6, ckpt_freq=4)
    tr = port_trainer(cfg)
    p, o = tr.init()
    fired = []

    def preempt(step, metrics):
        if step == 2 and not fired:
            fired.append(step)
            # only ever into the trainer's own handler
            assert signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, signal.SIG_IGN, None)
            os.kill(os.getpid(), signal.SIGTERM)

    tr.run(p, o, data(), seed=0, hooks=[preempt], workspace=str(tmp_path))
    tr2 = port_trainer(cfg)
    p, o = tr2.init()
    p, o, start = tr2.resume(p, o, str(tmp_path))
    assert start == 3
    it = data()
    for _ in range(start):
        next(it)
    got = tr2.run(p, o, it, seed=0, start_step=start)[0]
    assert_equal(got, uninterrupted(cfg))
