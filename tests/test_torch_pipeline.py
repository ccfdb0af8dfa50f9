"""The port's closed train-and-serve loop (`singa_tpu_torch/core/
pipeline.py` and `main.py`'s `pipeline` subcommand) against the JAX
package's, on the CPU: the controller cases of
`tests/test_pipeline_mode.py` (`:52`, `:171-435`).

Host logic runs once per package (`PKGS`) on fakes and stub engine
handles, and the port's observations must equal the JAX package's: the
`--pipeline_spec` grammar, the refusal of a fleet without a rollout,
blessing and the lag gauge, a publish fault counted, the lag alarm once
per blessed step, the Prometheus names and values, and the cold-start
rollout (the first publish promoted, or rejected and the canary back on
fresh-init params).  Then the real loop in the port: a supervised tiny
LM trainer with a preemption beside a 2-engine fleet under client load,
and `pipeline --smoke 8` on `examples/transformer/lm_tiny.conf` beside
the JAX CLI (both exit 0 with blessed == served, and the snapshots have
the same keys)."""

import dataclasses
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import singa_tpu.core.pipeline as jpipeline
import singa_tpu.serve as jserve
import singa_tpu.utils.faults as jfaults
from singa_tpu.main import main as jmain
from singa_tpu.obs.metrics import MetricsRegistry as JRegistry
from singa_tpu.utils.checkpoint import CheckpointManager as JCkpt

import singa_tpu_torch.core.pipeline as tpipeline
import singa_tpu_torch.serve as tserve
import singa_tpu_torch.utils.faults as tfaults
from singa_tpu_torch.main import main as tmain
from singa_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from singa_tpu_torch.utils.checkpoint import CheckpointManager as TCkpt

from test_torch_router import Stub

pytestmark = pytest.mark.port
PKGS = {
    "jax": SimpleNamespace(pipeline=jpipeline, serve=jserve, faults=jfaults,
                           registry=JRegistry, ckpt=JCkpt),
    "torch": SimpleNamespace(pipeline=tpipeline, serve=tserve,
                             faults=tfaults, registry=TRegistry, ckpt=TCkpt),
}
QUIET = dict(log_fn=lambda s: None)
CONF = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "transformer", "lm_tiny.conf")


def both(scenario, *args):
    """`scenario(pkg, *args)` for each package; the port's observations
    must equal the JAX package's.  Returns the port's."""
    got = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# -- the spec grammar ----------------------------------------------------------

@pytest.mark.parametrize("text", [
    "lag_alarm_s=5.5,join_s=120;seed=3", None, "", "seed=7",
    "bogus=1", "lag_alarm_s=0", "join_s=-1", "lag_alarm_s"])
def test_pipeline_spec_parses_alike(text):
    def parse(pkg):
        try:
            return dataclasses.asdict(pkg.pipeline.PipelineSpec.parse(text))
        except ValueError as e:
            return type(e).__name__
    both(parse)


# -- the controller over fakes ---------------------------------------------------

class _FakeTrainer:
    on_checkpoint = None


class _FakeSupervisor:
    def __init__(self):
        self.trainer = _FakeTrainer()
        self.failures = []


class _FakeFleet:
    def __init__(self):
        self.rollout = SimpleNamespace(pinned_step=-1)
        self.router = SimpleNamespace(names=lambda: ["e0"])

    def snapshot(self):
        return {"rollout": {"pinned_step": self.rollout.pinned_step}}


def _controller(pkg, logs=None, **spec_kw):
    sup, fleet = _FakeSupervisor(), _FakeFleet()
    ctl = pkg.pipeline.PipelineController(
        sup, fleet, "ws", spec=pkg.pipeline.PipelineSpec(**spec_kw),
        log_fn=logs.append if logs is not None else (lambda s: None))
    return ctl, sup, fleet


def test_controller_requires_a_rollout():
    def refuse(pkg):
        fleet = _FakeFleet()
        fleet.rollout = None
        with pytest.raises(ValueError, match="rollout") as ei:
            pkg.pipeline.PipelineController(_FakeSupervisor(), fleet, "ws")
        return str(ei.value)
    both(refuse)


def _lag(ctl):
    lag = ctl.lag()
    return {**lag, "lag_s": lag["lag_s"] >= 0.0}


def test_publish_blessing_and_lag_gauge():
    """Only ok/None verdicts bless a step; the lag pair tracks blessed
    minus served and drains (recording the promote latency) when the
    rollout catches up."""
    def scenario(pkg):
        ctl, sup, fleet = _controller(pkg)
        hook = sup.trainer.on_checkpoint
        assert hook is not None             # the controller wired it
        hook(4, "ok")
        hook(8, None)
        hook(12, "spike")                   # published, NOT blessed
        seen = [(ctl.published, ctl.unblessed), _lag(ctl)]
        fleet.rollout.pinned_step = 8       # the fleet catches up
        seen += [_lag(ctl), len(ctl.promote_lags_s)]
        snap = ctl.snapshot()
        seen += [sorted(snap), snap["published"], snap["blessed_step"],
                 snap["train"]]
        return seen
    got = both(scenario)
    assert got[0] == (3, 1)
    assert got[1] == {"blessed_step": 8, "served_step": -1,
                      "lag_steps": 9, "lag_s": True}
    assert got[2]["lag_steps"] == 0 and got[3] == 2
    assert got[5:7] == [3, 8] and got[7]["done"] is False


def test_publish_fault_degrades_to_counter():
    """An injected pipeline.publish fault neither loses the blessing
    (the rollout polls the fingerprint itself) nor raises back into the
    trainer."""
    def scenario(pkg):
        ctl, sup, _ = _controller(pkg)
        sched = pkg.faults.FaultSchedule.parse("pipeline.publish@1:error",
                                               seed=0)
        with pkg.faults.inject(sched):
            sup.trainer.on_checkpoint(5, "ok")
            sup.trainer.on_checkpoint(10, "ok")
        return ([f.site for f in sched.fired], ctl.publish_faults,
                ctl.published, ctl.last_blessed_step)
    assert both(scenario) == (["pipeline.publish"], 1, 2, 10)


def test_lag_alarm_fires_once_per_blessed_step():
    def scenario(pkg):
        logs = []
        ctl, sup, _ = _controller(pkg, logs, lag_alarm_s=0.01)
        sup.trainer.on_checkpoint(3, "ok")
        time.sleep(0.05)
        ctl.lag()
        ctl.lag()                           # same blessed step: no spam
        sup.trainer.on_checkpoint(6, "ok")
        time.sleep(0.05)
        ctl.lag()
        return [m.split(" unserved")[0] for m in logs if "lag alarm" in m]
    assert both(scenario) == [
        "warning: pipeline lag alarm — blessed step 3",
        "warning: pipeline lag alarm — blessed step 6"]


def test_controller_metrics_match_jax():
    def scenario(pkg):
        ctl, sup, fleet = _controller(pkg)
        reg = pkg.registry()
        ctl.register_into(reg)
        sup.trainer.on_checkpoint(6, "ok")
        sup.trainer.on_checkpoint(9, "spike")
        fleet.rollout.pinned_step = 6
        return sorted(line for line in reg.render_prometheus().splitlines()
                      if "singa_pipeline" in line)
    got = both(scenario)
    for line in ("singa_pipeline_blessed_step 6",
                 "singa_pipeline_served_step 6", "singa_pipeline_lag_steps 0",
                 "singa_pipeline_published_total 2",
                 "singa_pipeline_unblessed_total 1"):
        assert line in got, got


# -- the cold-start rollout on stubs ------------------------------------------------

def _cold_rollout(pkg, ws, n=2):
    stubs = [Stub(pkg, f"e{i}", step=-1) for i in range(n)]
    router = pkg.serve.Router(stubs, spec=pkg.serve.RouterSpec(), **QUIET)
    router.probe_all()
    ctrl = pkg.serve.RolloutController(
        router, ws, spec=pkg.serve.RolloutSpec(poll_s=0.05, window_s=0.2,
                                               min_requests=1), **QUIET)
    return ctrl, stubs


def _save(pkg, ws, step, verdict="ok"):
    pkg.ckpt(ws, log_fn=lambda s: None).save(
        step, {"w": np.ones((2,), np.float32)},
        {"t": np.zeros((), np.float32)}, health={"verdict": verdict})


def test_cold_start_first_publish_promotes_without_restart(tmp_path):
    """A checkpoint that lands BEFORE rollout.start() is still noticed,
    and the first blessed step promotes from a -1 cold start."""
    def scenario(pkg):
        ws = str(tmp_path / str(id(pkg)))
        ctrl, stubs = _cold_rollout(pkg, ws)
        _save(pkg, ws, 1)                   # lands before start()
        ctrl.start(-1)
        ctrl.stop()                         # keep ticks hand-driven
        ctrl.tick()                         # OBSERVE: sees step 1
        seen = [ctrl.state, ctrl.target_step]
        canary = next(s for s in stubs if s.name == ctrl.canary)
        canary.served += 3                  # canary traffic
        ctrl._deadline = time.monotonic() - 1.0
        ctrl.tick()                         # evaluate -> promote
        return seen + [ctrl.state, ctrl.pinned_step, ctrl.promotions,
                       ctrl.rollbacks, [s.step for s in stubs]]
    assert both(scenario) == ["CANARY", 1, "OBSERVE", 1, 1, 0, [1, 1]]


def test_cold_start_rejected_first_checkpoint_restores_fresh_init(tmp_path):
    """The FIRST checkpoint carries a diverged verdict: the canary goes
    back to fresh-init params (step -1) and no other engine touches the
    bad step; the rejected fingerprint is remembered."""
    def scenario(pkg):
        ws = str(tmp_path / str(id(pkg)))
        ctrl, stubs = _cold_rollout(pkg, ws)
        _save(pkg, ws, 2, verdict="diverged")
        ctrl.pinned_step, ctrl._fp = -1, None   # start() without a thread
        ctrl.tick()
        canary = next(s for s in stubs if s.name == ctrl.canary)
        others = [s for s in stubs if s is not canary]
        seen = [ctrl.state, canary.step, [s.step for s in others]]
        canary.served += 3
        ctrl._deadline = time.monotonic() - 1.0
        ctrl.tick()                         # evaluate -> rollback
        seen += [ctrl.rollbacks, ctrl.promotions, canary.step,
                 [s.step for s in others]]
        ctrl.tick()                         # no canary ping-pong
        return seen + [ctrl.state, ctrl.canaries]
    assert both(scenario) == ["CANARY", 2, [-1], 1, 0, -1, [-1],
                              "OBSERVE", 1]


# -- the real loop, in the port -----------------------------------------------------

def test_pipeline_blessed_reaches_traffic_with_trainer_restart(tmp_path):
    """A supervised tiny-LM trainer (a preemption at step 10) and a
    2-engine fleet under continuous client load: every blessed
    checkpoint reaches traffic, no response comes from below the
    promoted step, and no request fails."""
    from singa_tpu_torch.core.supervisor import Supervisor
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.models.transformer import (synthetic_token_batches,
                                                    transformer_lm)
    from singa_tpu_torch.utils.health import HealthMonitor, HealthSpec

    vocab, seq = 64, 16
    cfg = transformer_lm(vocab_size=vocab, num_layers=2, embed_dim=32,
                         num_heads=4, head_dim=8, seq_len=seq, batchsize=4,
                         train_steps=18)
    cfg.checkpoint_frequency = 6
    mon = HealthMonitor(HealthSpec(), log_fn=lambda s: None)
    tr = Trainer(cfg, {"data": {"input": (seq,), "target": (seq,)}},
                 log_fn=lambda s: None, device="cpu", health=mon)
    sup = Supervisor(tr, str(tmp_path), max_restarts=3, log=lambda s: None)
    net = tr.test_net or tr.train_net
    fleet = tserve.EngineFleet.local(
        net, tserve.ServeSpec.parse("buckets=2x6,max_new_tokens=4,"
                                    "batch_window_s=0.002"),
        2, workspace=str(tmp_path), params=net.init_params(0, device="cpu"),
        rollout_spec=tserve.RolloutSpec(poll_s=0.1, window_s=0.25,
                                        min_requests=1),
        device="cpu", **QUIET)
    ctl = tpipeline.PipelineController(
        sup, fleet, str(tmp_path), spec=tpipeline.PipelineSpec(
            lag_alarm_s=60), **QUIET)
    sched = tfaults.FaultSchedule.parse("step.train@10:preempt", seed=0)
    prompt = np.arange(1, 6, dtype=np.int32)
    failures, responses = 0, []
    with tfaults.inject(sched):
        ctl.start(lambda: synthetic_token_batches(4, seq, vocab, seed=5),
                  seed=0)
        try:
            deadline = time.monotonic() + 240.0
            while time.monotonic() < deadline:
                done = not ctl.train_running()
                lag = ctl.lag()
                pinned_before = fleet.rollout.pinned_step
                try:
                    out = ctl.generate(prompt)
                    responses.append((pinned_before, out["step"]))
                except Exception:  # noqa: BLE001 — counted, asserted 0
                    failures += 1
                if done and lag["lag_steps"] == 0 and \
                        lag["blessed_step"] >= 0:
                    break
            assert ctl.wait(timeout=30.0), "training never finished"
        finally:
            ctl.stop()
    assert ctl.train_error is None, ctl.train_error
    assert [f.kind for f in sup.failures] == ["preemption"]
    assert failures == 0
    lag = ctl.lag()
    assert lag["blessed_step"] == lag["served_step"] == 18
    assert lag["lag_steps"] == 0
    assert fleet.rollout.promotions >= 1 and fleet.rollout.rollbacks == 0
    for pinned_before, step in responses:
        assert step >= pinned_before, (pinned_before, step)
    assert {s for _, s in responses} <= {-1, 6, 12, 18}
    assert ctl.promote_lags_s and max(ctl.promote_lags_s) < 120.0


def _snapshot(out: str):
    """The snapshot line (the fleet's shutdown may log after it)."""
    return json.loads([line for line in out.splitlines()
                       if line.startswith("{")][-1])


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_pipeline_smoke_on_lm_tiny_matches_the_jax_cli(tmp_path, capsys):
    def argv(ws):
        return ["pipeline", "-model_conf", CONF, "--workspace", ws,
                "--synthetic", "--steps", "16", "--smoke", "8",
                "--serve_spec", "buckets=2x16,max_new_tokens=4",
                "--rollout_spec", "poll_s=0.1,window_s=0.25,min_requests=1"]
    assert tmain(argv(str(tmp_path / "t")), device="cpu") == 0
    got = _snapshot(capsys.readouterr().out)
    assert jmain(argv(str(tmp_path / "j"))) == 0
    want = _snapshot(capsys.readouterr().out)
    for snap in (got, want):
        assert snap["blessed_step"] == snap["served_step"] == 16
        assert snap["lag_steps"] == 0 and snap["fleet"]["failed"] == 0
        assert snap["train"]["error"] is None
    assert _keys(got) == _keys(want)
