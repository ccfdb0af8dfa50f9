"""The port's numeric-health sentinel (`singa_tpu_torch/utils/health.py`)
and the Trainer's use of it, on the CPU, against the JAX package's:
`HealthSpec.parse`, the `HealthMonitor`'s verdicts on the same metric
streams, `health_probes` on the same grads and params (rtol 1e-6: both
accumulate each leaf in f32 and add the leaves in sorted key order; the
port squares each leaf's f32 norm, and the order inside a leaf's
reduction differs), probes that leave
the trajectory bit-equal, `step.grad@3:nan` raising with the JAX
`(step, status, metric)`, a fatal window's save refused, the
`skip_unhealthy` walk-back, and a serving poll after a torn save."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.utils import checkpoint as jckpt
from singa_tpu.utils import faults as jfaults
from singa_tpu.utils import health as jhealth

from singa_tpu_torch.config import model_config_from_dict
from singa_tpu_torch.serve.engine import InferenceEngine, ServeSpec
from singa_tpu_torch.utils import health
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.utils.faults import FaultSchedule, inject
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from test_torch_supervisor import (SHAPES, assert_equal, data, jax_trainer,
                                   jdata, mlp, port_trainer, uninterrupted)

pytestmark = pytest.mark.port

SPECS = [None, "", "grad_norm_max=1e4, spike_mad=8; patience=2,"
         "blame_batches=3,lr_backoff=0.5",
         "window=16,warmup=4,ewma_alpha=0.25,param_drift_max=3,loss_max=50",
         "max_divergences=5;update_ratio_max=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_health_spec_parses_as_the_jax_spec(spec):
    got = health.HealthSpec.parse(spec)
    want = jhealth.HealthSpec.parse(spec)
    assert vars(got) == vars(want)


@pytest.mark.parametrize("bad", ["nope=1", "window=abc", "patience"])
def test_health_spec_rejects_what_the_jax_spec_rejects(bad):
    with pytest.raises(ValueError) as got:
        health.HealthSpec.parse(bad)
    with pytest.raises(ValueError) as want:
        jhealth.HealthSpec.parse(bad)
    assert str(got.value) == str(want.value)


def _stream(seed: int, n: int = 120):
    """Metric dicts: steady noisy values with NaNs, infinities, isolated
    and consecutive spikes (patience), hard-cap breaches and param
    drift, at seeded places."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        m = {"loss": float(2.0 + 0.05 * rng.standard_normal()),
             "health/grad_norm": float(1.0 + 0.1 * rng.standard_normal()),
             "health/param_norm": float(10.0 + 0.01 * s),
             "health/update_ratio": float(1e-3 * (1 + rng.random())),
             "precision": 0.5}
        r = rng.random()
        if r < 0.03:
            m["loss"] = float("nan")
        elif r < 0.05:
            m["health/grad_norm"] = float("inf")
        elif r < 0.15:
            m["health/grad_norm"] *= 50.0          # spike
        elif r < 0.2:
            m["loss"] *= 40.0                      # spike
        elif r < 0.22:
            m["health/update_ratio"] = 20.0        # over the cap
        elif r < 0.25:
            m["health/param_norm"] *= 5.0          # drift
        out.append(m)
    # three consecutive spikes: patience escalates to DIVERGED
    for s in (60, 61, 62):
        out[s]["health/grad_norm"] = 80.0
    return out


ALL = {"ok", "spike", "diverged", "nonfinite"}


@pytest.mark.parametrize("seed,spec,statuses_seen", [
    (0, None, ALL), (1, "warmup=4,spike_mad=6,patience=2", ALL),
    (2, "param_drift_max=2,loss_max=30,window=8", ALL),
    # no cap and no patience: nothing escalates to DIVERGED
    (3, "patience=0,grad_norm_max=0,update_ratio_max=0",
     ALL - {"diverged"})])
def test_monitor_verdicts_equal_the_jax_monitor(seed, spec, statuses_seen):
    tmon = health.HealthMonitor(health.HealthSpec.parse(spec),
                                log_fn=lambda s: None)
    jmon = jhealth.HealthMonitor(jhealth.HealthSpec.parse(spec),
                                 log_fn=lambda s: None)
    statuses = set()
    for s, m in enumerate(_stream(seed)):
        got, want = tmon.observe(s, m), jmon.observe(s, m)
        assert (got.step, got.status, got.metric) == \
            (want.step, want.status, want.metric), s
        for a, b in ((got.value, want.value),
                     (got.threshold, want.threshold)):
            assert (a is None and b is None) or a == b or \
                (math.isnan(a) and math.isnan(b)), s
        assert tmon.ok_to_save() == jmon.ok_to_save(), s
        assert repr(tmon.snapshot_health()) == \
            repr(jmon.snapshot_health()), s
        if s % 9 == 8:
            tmon.mark_snapshot()
            jmon.mark_snapshot()
        statuses.add(got.status)
    assert tmon.counts == jmon.counts
    assert statuses == statuses_seen
    tmon.reset()
    jmon.reset()
    assert tmon.counts == jmon.counts and tmon.ok_to_save()


def test_health_probes_agree_with_the_jax_probes():
    rng = np.random.default_rng(7)
    shapes = {"b/w": (33, 17), "a/bias": (17,), "c/emb": (64, 8)}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    old = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    new = {k: v - 1e-3 * grads[k] for k, v in old.items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}       # noqa: E731
    got = health.health_probes(t(grads), t(old), t(new))
    want = jhealth.health_probes(j(grads), j(old), j(new))
    assert set(got) == set(want) == {health.GRAD_NORM, health.PARAM_NORM,
                                     health.UPDATE_RATIO}
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    ok, norm = health.delta_health(t(grads), t(old), max_norm=1e9)
    jok, jnorm = jhealth.delta_health(j(grads), j(old), max_norm=1e9)
    assert ok == jok and np.isclose(norm, jnorm, rtol=1e-6)
    grads["a/bias"][3] = np.nan
    assert health.delta_health(t(grads))[0] is False


def test_probes_ride_the_metrics_and_leave_the_trajectory_bit_equal():
    want = uninterrupted(mlp(6, ckpt_freq=0))
    seen = {}
    mon = health.HealthMonitor(log_fn=lambda s: None)
    tr = port_trainer(mlp(6, ckpt_freq=0), health=mon)
    p, o = tr.init()
    got = tr.run(p, o, data(), seed=0,
                 hooks=[lambda s, m: seen.setdefault(s, m)])[0]
    assert_equal(got, want)
    jmon = jhealth.HealthMonitor(log_fn=lambda s: None)
    jseen = {}
    jtr = jax_trainer(mlp(6, ckpt_freq=0), health=jmon)
    jp, jo = jtr.init()
    jtr.run(jp, jo, jdata(), seed=0,
            hooks=[lambda s, m: jseen.setdefault(s, m)])
    for s in range(6):
        for key in (health.GRAD_NORM, health.PARAM_NORM,
                    health.UPDATE_RATIO):
            np.testing.assert_allclose(seen[s][key], float(jseen[s][key]),
                                       rtol=1e-5, err_msg=(s, key))
    assert mon.counts[health.OK] == 6 == jmon.counts[jhealth.OK]


def test_nan_at_step_grad_raises_the_jax_divergence():
    tr = port_trainer(mlp(8, ckpt_freq=0),
                      health=health.HealthMonitor(log_fn=lambda s: None))
    p, o = tr.init()
    with inject(FaultSchedule.parse("step.grad@3:nan")):
        with pytest.raises(health.NumericDivergence) as ei:
            tr.run(p, o, data(), seed=0)
    jtr = jax_trainer(mlp(8, ckpt_freq=0),
                      health=jhealth.HealthMonitor(log_fn=lambda s: None))
    jp, jo = jtr.init()
    with jfaults.inject(jfaults.FaultSchedule.parse("step.grad@3:nan")):
        with pytest.raises(jhealth.NumericDivergence) as jei:
            jtr.run(jp, jo, jdata(), seed=0)
    got, want = ei.value, jei.value
    assert (got.step, got.status, got.metric) == \
        (want.step, want.status, want.metric) == (3, "nonfinite",
                                                  "grad_norm")


def test_a_fatal_window_is_refused_its_save(tmp_path):
    logs, published = [], []
    mon = health.HealthMonitor(log_fn=lambda s: None)
    tr = port_trainer(mlp(4, ckpt_freq=2), health=mon, log=logs.append)
    tr.on_checkpoint = lambda s, v: published.append((s, v))
    ckpt = CheckpointManager(str(tmp_path), log_fn=lambda s: None)
    p, o = tr.init()
    assert tr._save_checkpoint(ckpt, 2, p, o) is True
    mon.observe(2, {"loss": float("nan")})     # poison the window
    assert tr._save_checkpoint(ckpt, 4, p, o) is False
    assert ckpt.available_steps() == [2]
    assert any("refusing checkpoint" in l for l in logs)
    assert published == [(2, "ok")]
    assert ckpt.health_verdict(2) == "ok"


def test_skip_unhealthy_walks_back_past_bad_verdicts(tmp_path, monkeypatch):
    """The spike at step 9 taints the step-12 snapshot; nan at 13 stops
    the run (raised before the step-16 save).  A `skip_unhealthy` resume
    lands on step 8, and the JAX package reads the same verdicts from
    the port's manifest."""
    ws = str(tmp_path)
    spec = health.HealthSpec(grad_norm_max=0.0, update_ratio_max=0.0,
                             spike_mad=8, patience=10)
    tr = port_trainer(mlp(20, ckpt_freq=4),
                      health=health.HealthMonitor(spec,
                                                  log_fn=lambda s: None))
    p, o = tr.init()
    with inject(FaultSchedule.parse("step.grad@9:spike,step.grad@13:nan")):
        with pytest.raises(health.NumericDivergence):
            tr.run(p, o, data(), seed=0, workspace=ws)
    ckpt = CheckpointManager(ws, log_fn=lambda s: None)
    assert ckpt.available_steps() == [4, 8, 12]
    assert [ckpt.health_verdict(s) for s in (4, 8, 12)] == \
        ["ok", "ok", "spike"]
    logs = []
    tr.log = logs.append
    p, o, step = tr.resume(p, o, ws, skip_unhealthy=True)
    assert step == 8
    assert any("verdict 'spike'; skipping" in l for l in logs), logs
    assert tr.resume(p, o, ws)[2] == 12
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    jmgr = jckpt.CheckpointManager(ws, log_fn=lambda s: None)
    assert [jmgr.health_verdict(s) for s in (4, 8, 12)] == \
        ["ok", "ok", "spike"]
    assert jmgr.restore(skip_unhealthy=True)[2] == 8


def test_a_torn_last_save_does_not_hold_a_serving_poll(tmp_path):
    """A torn save leaves a newest snapshot with no manifest entry and no
    record to come.  The poll must not take it for a save in flight
    forever: it refuses it (the snapshot is unreadable) and keeps
    serving the last good step, and a later good save reloads."""
    from singa_tpu_torch.models.transformer import transformer_lm
    from singa_tpu_torch.core.net import build_net
    cfg = transformer_lm(vocab_size=32, num_layers=1, embed_dim=16,
                         num_heads=2, head_dim=8, seq_len=8, batchsize=2)
    net = build_net(cfg, "kTrain", {"data": {"input": (8,),
                                             "target": (8,)}})
    arrays = numpy_params(net, seed=0)
    opt = {"history": {k: np.zeros_like(v) for k, v in arrays.items()}}
    ws = str(tmp_path)
    mgr = CheckpointManager(ws, log_fn=lambda s: None)
    mgr.save(4, arrays, opt, health={"verdict": "ok"})
    eng = InferenceEngine(net, ServeSpec(buckets=((1, 8),),
                                         max_new_tokens=2),
                          params_from_numpy(net, arrays, device="cpu"),
                          device="cpu", workspace=ws,
                          log_fn=lambda s: None)
    eng.load()
    assert eng.params_step == 4
    with inject(FaultSchedule.parse("ckpt.save@0:torn")):
        mgr.save(8, arrays, opt, health={"verdict": "ok"})
    assert mgr.available_steps() == [4, 8]
    assert not mgr.save_in_flight()
    outcomes = [eng.poll_reload() for _ in range(3)]
    assert outcomes == ["refused", "unchanged", "unchanged"]
    assert eng.params_step == 4
    # a save between its rename and its record is still in flight
    mgr._manifest_record = lambda *a, **k: None
    mgr.save(12, arrays, opt, health={"verdict": "ok"})
    assert mgr.save_in_flight()
    del mgr._manifest_record
    mgr.save(12, arrays, opt, health={"verdict": "ok"})
    assert eng.poll_reload() == "reloaded" and eng.params_step == 12
