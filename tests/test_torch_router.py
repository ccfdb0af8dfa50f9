"""The port's serving control plane held against the JAX package's, as
host logic: `RouterSpec`, `RolloutSpec` and `AutoScaleSpec` parse the
JAX tests' spec strings alike; on scriptable stub engine handles the
two `Router`s pick, retry, strike, quarantine, readmit, shed, hedge and
brown out alike, and end with equal `RouterStats` snapshots; the
rollout state machine canaries one stub and promotes or rolls back;
`AutoScaler.decide` gives the same decisions on the same signal
sequences and `tick` grows and drains through the router; `obs.collect`
merges the same buffers to the same trace; `TrafficGen` accounts every
offered request.  Each scenario runs once per package (`PKGS`) and
the port's observations must equal the JAX package's.  No engine, no
device: every stub answers from the host."""

import dataclasses
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import singa_tpu.obs.collect as jcollect
import singa_tpu.parallel.bootstrap as jbootstrap
import singa_tpu.serve as jserve
import singa_tpu.utils.faults as jfaults
from singa_tpu.obs.metrics import MetricsRegistry as JRegistry
from singa_tpu.utils.checkpoint import CheckpointManager as JCkpt

import singa_tpu_torch.obs.collect as tcollect
import singa_tpu_torch.parallel.bootstrap as tbootstrap
import singa_tpu_torch.serve as tserve
import singa_tpu_torch.utils.faults as tfaults
from singa_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from singa_tpu_torch.utils.checkpoint import CheckpointManager as TCkpt

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
PKGS = {
    "jax": SimpleNamespace(serve=jserve, faults=jfaults, collect=jcollect,
                           ckpt=JCkpt, registry=JRegistry,
                           bootstrap=jbootstrap),
    "torch": SimpleNamespace(serve=tserve, faults=tfaults,
                             collect=tcollect, ckpt=TCkpt,
                             registry=TRegistry, bootstrap=tbootstrap),
}
QUIET = dict(log_fn=lambda s: None)


def both(scenario, *args):
    """`scenario(pkg, *args)` for each package; the port's observations
    must equal the JAX package's.  Returns the port's."""
    got = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# -- spec grammars --------------------------------------------------------------

SPECS = {
    "RouterSpec": (["probe_period_s=0.1,quarantine_after=3;"
                    "readmit_base_s=0.5,max_attempts=2", None, "",
                    "hedge=OFF,resume=off,stream_idle_s=0.5",
                    "wal=off,wal_group_tokens=4,flush_ms=0"],
                   ["bogus=1", "quarantine_after=0", "hedge=maybe",
                    "hedge_min_s=2,hedge_max_s=1", "flush_tokens=0",
                    "probe_period_s"]),
    "RolloutSpec": (["window_s=2.5,min_requests=10;p95_ratio=4", "", None,
                     "poll_s=0.05,max_extends=0,err_tolerance=0.5"],
                    ["nope=2", "window_s=0", "p95_ratio=-1", "poll_s=x"]),
    "AutoScaleSpec": (["slo_p95_ms=150,max_engines=8;cooldown_s=1.5,"
                       "quiet_ticks=5", None, "",
                       "min_engines=2,max_engines=2,tick_s=0.1"],
                      ["bogus=1", "min_engines=0",
                       "min_engines=3,max_engines=2", "down_margin=1"]),
}


def _parse(pkg, kind, text):
    try:
        return dataclasses.asdict(getattr(pkg.serve, kind).parse(text))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_spec_grammars_parse_alike(kind):
    good, bad = SPECS[kind]
    for text in good:
        got = both(_parse, kind, text)
        assert isinstance(got, dict), (text, got)
    for text in bad:
        assert both(_parse, kind, text).startswith("ValueError"), text


def test_parse_hostfile_alike(tmp_path):
    cases = {"ok": "# fleet\n10.0.0.1:8000\n\n10.0.0.2  # second\nh3\n",
             "dup": "10.0.0.1:8000\n10.0.0.2:8000\n10.0.0.1:8000\n",
             "empty": "# fleet members\n\n   \n# none yet\n"}
    for name, text in cases.items():
        p = tmp_path / name
        p.write_text(text)

        def read(pkg):
            try:
                return pkg.bootstrap.parse_hostfile(str(p))
            except ValueError as e:
                return str(e)
        got = both(read)
        if name == "ok":
            assert got == ["10.0.0.1:8000", "10.0.0.2", "h3"]


# -- stub engine handles --------------------------------------------------------

class Stub:
    """Engine-handle double: scriptable health, load, latency, failure
    and reload; raises package `pkg`'s exceptions."""

    def __init__(self, pkg, name, step=1, queue_depth=0, delay_s=0.0):
        self.pkg = pkg
        self.name = name
        self.step = step
        self.queue_depth = queue_depth
        self.delay_s = delay_s
        self.fail_probe = False
        self.fail_request = False
        self.overloaded = False
        self.reload_error = False
        self.occupancy = None
        self.served = 0
        self.calls = []

    def probe(self):
        if self.fail_probe:
            raise self.pkg.serve.EngineUnavailable(f"{self.name} is down")
        return {"ok": True, "status": "ok", "step": self.step,
                "queue_depth": self.queue_depth}

    def stats_snapshot(self):
        snap = {"completed": self.served, "failed": 0, "expired": 0,
                "p95_latency_ms": None}
        if self.occupancy is not None:
            snap["cb_slot_occupancy"] = self.occupancy
        return snap

    def request(self, mode, tokens, timeout=None, deadline=None,
                priority="interactive", cancel_event=None):
        self.calls.append({"priority": priority, "deadline": deadline,
                           "cancel_event": cancel_event})
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail_request:
            raise self.pkg.serve.EngineUnavailable(f"{self.name} crashed")
        if self.overloaded:
            raise self.pkg.serve.Overloaded(f"{self.name} full",
                                            retry_after=0.01)
        self.served += 1
        return {"tokens": [1, 2], "step": self.step}

    def reload(self, step=None):
        if self.reload_error:
            raise self.pkg.serve.EngineUnavailable(f"{self.name} is down")
        if step is not None and step != self.step:
            self.step = step
            return {"outcome": "reloaded", "step": step}
        return {"outcome": "unchanged", "step": self.step}


def _router(pkg, n=3, **spec_kw):
    spec_kw.setdefault("quarantine_after", 2)
    spec_kw.setdefault("readmit_base_s", 0.01)
    spec_kw.setdefault("readmit_cap_s", 0.02)
    spec_kw.setdefault("hedge", "off")
    stubs = [Stub(pkg, f"e{i}") for i in range(n)]
    r = pkg.serve.Router(stubs, spec=pkg.serve.RouterSpec(**spec_kw),
                         **QUIET)
    r.probe_all()                       # first verdicts, no probe thread
    return r, stubs


# counters of RouterStats.snapshot() that the host logic decides (the
# latency quantiles and recent rates are wall-clock readings)
COUNTERS = ("routed", "completed", "retried", "failed", "shed",
            "quarantines", "readmissions", "joins", "retires", "attempts",
            "hedges", "hedge_wins", "deadline_terminal",
            "expired_on_arrival", "budget_denied", "brownout_sheds",
            "shed_interactive", "shed_batch", "shed_best_effort",
            "unknown_model", "lame_duck_refusals")


def _view(r):
    snap = r.snapshot()
    members = [{k: m[k] for k in ("name", "healthy", "quarantined",
                                  "strikes", "step", "dispatched",
                                  "failed", "quarantines")}
               for m in snap["engines"]]
    return {"counters": {k: snap[k] for k in COUNTERS},
            "members": members, "healthy": snap["healthy_engines"]}


def sc_least_loaded(pkg):
    r, stubs = _router(pkg)
    stubs[0].queue_depth, stubs[2].queue_depth = 5, 3
    r.probe_all()
    out = r.route("generate", [1, 2])
    return {"engine": out["engine"], "served": [s.served for s in stubs],
            **_view(r)}


def sc_retry_and_strike(pkg):
    r, stubs = _router(pkg, 2, quarantine_after=1)
    stubs[1].queue_depth = 9            # e0 is preferred...
    r.probe_all()
    stubs[0].fail_request = True        # ...but crashed
    out = r.route("generate", [1, 2])
    return {"engine": out["engine"], **_view(r)}


def sc_quarantine_and_readmit(pkg):
    r, stubs = _router(pkg, 2)
    stubs[0].fail_probe = True
    seen = []
    for _ in range(2):                  # strike 1, strike 2 -> benched
        r.probe_all()
        seen.append(r.healthy_names())
    stubs[0].fail_probe = False
    time.sleep(0.05)                    # past readmit_cap_s
    r.probe_all()
    seen.append(sorted(r.healthy_names()))
    return {"seen": seen, **_view(r)}


def sc_escalating_shed(pkg):
    r, stubs = _router(pkg, 2, quarantine_after=1)
    for s in stubs:
        s.fail_probe = True
    r.probe_all()
    delays = []
    for _ in range(3):
        with pytest.raises(pkg.serve.Overloaded) as ei:
            r.route("generate", [1])
        delays.append(ei.value.retry_after)
    assert delays[0] < delays[2]
    return {"delays": delays, **_view(r)}


def sc_dispatch_fault_and_overload(pkg):
    r, stubs = _router(pkg, 2, quarantine_after=1)
    with pkg.faults.inject(pkg.faults.FaultSchedule.parse(
            "fleet.dispatch@0:error")):
        first = r.route("generate", [1, 2])["engine"]
    healthy = r.healthy_names()
    stubs[int(healthy[0][1])].overloaded = True
    with pytest.raises(pkg.serve.Overloaded):
        r.route("generate", [1])        # load, not failure: no strike
    return {"first": first, **_view(r)}


def sc_hedge_first_wins(pkg):
    r, stubs = _router(pkg, 2, hedge="on", hedge_min_s=0.01,
                       hedge_max_s=0.05)
    stubs[0].delay_s = 0.6
    t0 = time.monotonic()
    out = r.route("generate", [1, 2])
    fast = time.monotonic() - t0 < 0.5
    cancel = stubs[0].calls[0]["cancel_event"]
    assert cancel.wait(2.0)             # the loser was told to stop
    return {"engine": out["engine"], "fast": fast, **_view(r)}


def sc_brownout(pkg):
    r, stubs = _router(pkg, 2, brownout_shed_rate=0.1)

    def pressurize(rate):
        """Pin the cached capacity-shed pressure of the default tenant."""
        r._pressure_by_tenant = {"default": rate}
        r._pressure_t = time.monotonic() + 60.0

    outcomes = []
    for rate, prio in ((0.15, "best_effort"), (0.15, "batch"),
                       (0.15, "interactive"), (0.5, "batch"),
                       (0.5, "interactive"), (1.0, "best_effort"),
                       (1.0, "best_effort")):
        pressurize(rate)
        try:
            r.route("generate", [1, 2], priority=prio)
            outcomes.append("ok")
        except pkg.serve.Overloaded as e:
            outcomes.append(round(e.retry_after, 9))
    return {"outcomes": outcomes, **_view(r)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_least_loaded, sc_retry_and_strike, sc_quarantine_and_readmit,
    sc_escalating_shed, sc_dispatch_fault_and_overload,
    sc_hedge_first_wins, sc_brownout)}
EXPECT = {
    "least_loaded": lambda o: o["engine"] == "e1"
    and o["served"] == [0, 1, 0],
    "retry_and_strike": lambda o: o["engine"] == "e1"
    and o["counters"]["retried"] == 1 and o["members"][0]["quarantined"],
    "quarantine_and_readmit": lambda o:
    o["seen"][1:] == [["e1"], ["e0", "e1"]]
    and o["counters"]["quarantines"] == 1
    and o["counters"]["readmissions"] == 1,
    "escalating_shed": lambda o: o["counters"]["shed"] == 3,
    "dispatch_fault_and_overload": lambda o:
    o["counters"]["retried"] == 2 and o["counters"]["completed"] == 1
    and o["counters"]["shed"] == 1 and o["counters"]["failed"] == 0
    and sum(m["quarantined"] for m in o["members"]) == 1,
    "hedge_first_wins": lambda o: o["engine"] == "e1" and o["fast"]
    and o["counters"]["hedges"] == 1 and o["counters"]["hedge_wins"] == 1,
    "brownout": lambda o: o["outcomes"][1:3] == ["ok", "ok"]
    and o["outcomes"][4] == "ok" and o["outcomes"][0] != "ok"
    and o["outcomes"][3] != "ok"
    and o["outcomes"][5] < o["outcomes"][6]
    and o["counters"]["brownout_sheds"] == 4
    and o["counters"]["shed_interactive"] == 0,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_the_jax_router(name):
    got = both(SCENARIOS[name])
    assert EXPECT[name](got), got


# -- rollout on stubs -----------------------------------------------------------

def _rollout(pkg, verdicts, dead_canary=False):
    """Save step 1, arm a controller pinned there, then save one step
    per verdict, ticking by hand: what each tick left on the stubs."""
    trail = []
    with tempfile.TemporaryDirectory() as ws:
        mgr = pkg.ckpt(ws, log_fn=lambda s: None)
        w = {"w": np.ones((2,), np.float32)}
        mgr.save(1, w, {"t": np.zeros((), np.float32)},
                 health={"verdict": "ok"})
        r, stubs = _router(pkg, 3, quarantine_after=1)
        ctrl = pkg.serve.RolloutController(
            r, ws, spec=pkg.serve.RolloutSpec(
                window_s=60.0 if dead_canary else 0.01), **QUIET)
        ctrl.pinned_step = 1
        ctrl._fp = ctrl.mgr.fingerprint()
        for step, verdict in enumerate(verdicts, start=2):
            mgr.save(step, w, {"t": np.zeros((), np.float32)},
                     health={"verdict": verdict})
            ctrl.tick()
            trail.append((ctrl.state, sorted(s.step for s in stubs)))
            if dead_canary:
                victim = next(s for s in stubs if s.step == step)
                victim.fail_probe = victim.reload_error = True
                r.probe_all()
            else:
                time.sleep(0.03)
            ctrl.tick()
            trail.append((ctrl.state, sorted(s.step for s in stubs)))
        trail.append(r.route("generate", [1])["step"])
        return {"trail": trail, "canaries": ctrl.canaries,
                "promotions": ctrl.promotions,
                "rollbacks": ctrl.rollbacks,
                "pinned": ctrl.pinned_step}


def test_rollout_promotes_a_healthy_save_and_rolls_back_a_diverged_one():
    got = both(_rollout, ["ok", "diverged"])
    assert got["trail"] == [("CANARY", [1, 1, 2]), ("OBSERVE", [2, 2, 2]),
                            ("CANARY", [2, 2, 3]), ("OBSERVE", [2, 2, 2]),
                            2]
    assert (got["canaries"], got["promotions"], got["rollbacks"],
            got["pinned"]) == (2, 1, 1, 2)


def test_rollout_rolls_back_when_the_canary_dies():
    got = both(_rollout, ["ok"], True)
    assert got["trail"][0] == ("CANARY", [1, 1, 2])
    assert got["trail"][1][0] == "OBSERVE" and got["trail"][2] == 1
    assert got["rollbacks"] == 1 and got["pinned"] == 1


class SlowHistoryStub(Stub):
    """A stub whose own latency window holds slow requests from before
    any canary, as an engine's holds a co-located trainer's start-up
    stall (PR 15's chip call 1)."""

    def stats_snapshot(self):
        return {**super().stats_snapshot(), "p95_latency_ms": 300.0}


def _canary_window(pkg, in_window_s):
    """A pinned step 1, 20 requests of 20 ms, then step 2 canaried: the
    other engine is full, so 5 requests reach the canary, each taking
    `in_window_s`.  Returns (promotions, rollbacks)."""
    with tempfile.TemporaryDirectory() as ws:
        mgr = pkg.ckpt(ws, log_fn=lambda s: None)
        w = {"w": np.ones((2,), np.float32)}
        t = {"t": np.zeros((), np.float32)}
        mgr.save(1, w, t, health={"verdict": "ok"})
        stubs = [SlowHistoryStub(pkg, f"e{i}", delay_s=0.02)
                 for i in range(2)]
        r = pkg.serve.Router(stubs, spec=pkg.serve.RouterSpec(
            hedge="off"), **QUIET)
        r.probe_all()
        ctrl = pkg.serve.RolloutController(
            r, ws, spec=pkg.serve.RolloutSpec(window_s=0.01), **QUIET)
        ctrl.pinned_step = 1
        ctrl._fp = ctrl.mgr.fingerprint()
        for _ in range(20):
            r.route("generate", [1])
        mgr.save(2, w, t, health={"verdict": "ok"})
        ctrl.tick()
        assert ctrl.state == "CANARY"
        for s in stubs:
            if s.name == ctrl.canary:
                s.delay_s = in_window_s
            else:
                s.overloaded = True
        for _ in range(5):
            r.route("generate", [1])
        ctrl.tick()
        return ctrl.promotions, ctrl.rollbacks


def test_a_canary_is_judged_on_its_own_window():
    """Fault C7 (found by `chip_smoke.py` phase 16 on the card): the
    rollout compared the canary engine's p95 over its whole latency
    window, requests from before the reload included, with the router's
    p95; beside a trainer on the same card an engine that had served
    little kept the trainer's start-up stall in that window, and every
    canary on it was rolled back (blessed 60, served -1 for good).  The
    port judges the p95 of the requests the canary served in its own
    window: the slow history alone promotes (the JAX package rolls
    back), a canary slow in its window still rolls back."""
    assert _canary_window(PKGS["torch"], 0.02) == (1, 0)
    assert _canary_window(PKGS["jax"], 0.02) == (0, 1)
    assert _canary_window(PKGS["torch"], 0.2) == (0, 1)


class SavingStub(Stub):
    """A stub that saves step `then` to the workspace while it reloads
    to step `when` (a trainer's save landing during a promotion)."""

    def __init__(self, pkg, name, mgr, when, then):
        super().__init__(pkg, name)
        self.mgr, self.when, self.then = mgr, when, then

    def reload(self, step=None):
        out = super().reload(step)
        if step == self.when and self.mgr is not None:
            self.mgr.save(self.then, {"w": np.ones((2,), np.float32)},
                          {"t": np.zeros((), np.float32)},
                          health={"verdict": "ok"})
            self.mgr = None
        return out


def _save_during_promote(pkg):
    """Step 2 is canaried and promoted; the sibling's reload to it saves
    step 3.  Returns (state, target) after the next tick."""
    with tempfile.TemporaryDirectory() as ws:
        mgr = pkg.ckpt(ws, log_fn=lambda s: None)
        w = {"w": np.ones((2,), np.float32)}
        t = {"t": np.zeros((), np.float32)}
        mgr.save(1, w, t, health={"verdict": "ok"})
        stubs = [Stub(pkg, "e0"), SavingStub(pkg, "e1", mgr, 2, 3)]
        r = pkg.serve.Router(stubs, spec=pkg.serve.RouterSpec(
            hedge="off"), **QUIET)
        r.probe_all()
        ctrl = pkg.serve.RolloutController(
            r, ws, spec=pkg.serve.RolloutSpec(window_s=0.01), **QUIET)
        ctrl.pinned_step = 1
        ctrl._fp = ctrl.mgr.fingerprint()
        mgr.save(2, w, t, health={"verdict": "ok"})
        ctrl.tick()
        assert ctrl.canary == "e0"          # the sibling, e1, saves
        time.sleep(0.02)
        ctrl.tick()                         # promote: the sibling saves 3
        assert ctrl.pinned_step == 2
        ctrl.tick()
        return ctrl.state, ctrl.target_step


def test_a_save_during_a_promotion_is_canaried_next():
    """Fault C9 (found by `chip_smoke.py` phase 16 on the card): a
    promotion took the workspace's fingerprint after its sibling
    reloads, so a save that landed meanwhile counted as seen and was
    never canaried until another save came (with a pipeline's last
    save, never: blessed stayed above served).  The fingerprint stays
    the one the tick began from."""
    assert _save_during_promote(PKGS["torch"]) == ("CANARY", 3)
    assert _save_during_promote(PKGS["jax"]) == ("OBSERVE", None)


# -- the autoscaler ---------------------------------------------------------------

class StubFleet:
    """Fleet double over a real Router: grow and retire go through the
    router's membership paths."""

    def __init__(self, pkg, n):
        self.pkg = pkg
        self.router, self.stubs = _router(pkg, n)
        self.rollout = None
        self._next = n

    def grow(self):
        h = Stub(self.pkg, f"e{self._next}")
        self._next += 1
        self.stubs.append(h)
        self.router.add_engine(h)
        return h.name

    def retire(self, name, drain=True, timeout_s=30.0):
        return self.router.remove_engine(name, drain=drain,
                                         timeout_s=timeout_s)


def _scaler(pkg, n=1, **kw):
    for k, v in dict(cooldown_s=0.0, window_s=5.0, tick_s=0.01,
                     quiet_ticks=2, max_engines=3).items():
        kw.setdefault(k, v)
    fleet = StubFleet(pkg, n)
    return pkg.serve.AutoScaler(fleet, spec=pkg.serve.AutoScaleSpec(**kw),
                                **QUIET), fleet


def _signals(seed, n=200):
    """Runs of quiet readings (long enough, some of them, for a
    scale-down) between random ones."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        eng = int(rng.integers(1, 4))
        quiet = {"n": eng, "healthy": eng, "queue_depth": 0,
                 "shed_rate": 0.0, "qps": 1.0, "p95_ms": 5.0,
                 "occupancy": 0.1, "lag_steps": 0}
        out += [dict(quiet)] * int(rng.integers(0, 6))
        out.append({
            "n": eng, "healthy": eng,
            "queue_depth": int(rng.choice([0, 0, 1, 4, 40])),
            "shed_rate": float(rng.choice([0.0, 0.0, 0.0, 0.01, 0.3])),
            "qps": float(rng.uniform(0, 50)),
            "p95_ms": (None if rng.random() < 0.3
                       else float(rng.choice([5.0, 80.0, 900.0, 5e4]))),
            "occupancy": (None if rng.random() < 0.3
                          else float(rng.uniform(0, 1))),
            "lag_steps": int(rng.choice([0, 0, 0, 2]))})
    return out


def _decisions(pkg, seed):
    sc, _ = _scaler(pkg, 2, quiet_ticks=3, min_engines=1)
    return [sc.decide(sig) for sig in _signals(seed)]


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_decides_alike_on_the_same_signals(seed):
    got = both(_decisions, seed)
    dirs = {d["dir"] for d in got}
    assert dirs == {"up", "down", "hold"}, dirs


def _ticks(pkg):
    sc, fleet = _scaler(pkg, 1, quiet_ticks=2, min_engines=1)
    fleet.router.stats.count("routed", 10)
    fleet.router.stats.count("shed", 5)
    actions = [sc.tick()]               # pressure: grow
    names = [fleet.router.names()]
    fleet.router.stats = pkg.serve.RouterStats(window_s=5.0)
    with pkg.faults.inject(pkg.faults.FaultSchedule.parse(
            "scale.decide@0:error")):
        actions.append(sc.tick())       # faulted: no action
    for _ in range(3):                  # quiet streak, then drain
        time.sleep(0.02)                # past the 8 ms cooldown cap
        actions.append(sc.tick())
        t = sc._action_thread
        if t is not None:
            t.join(5.0)
        deadline = time.monotonic() + 5.0
        while sc._busy and time.monotonic() < deadline:
            time.sleep(0.002)
        names.append(fleet.router.names())
    snap = sc.snapshot()
    reg = pkg.registry()
    sc.register_into(reg)
    text = reg.render_prometheus()
    return {"actions": actions, "names": names,
            "counts": {k: snap[k] for k in ("scale_ups", "scale_downs",
                                            "decide_faults", "aborts",
                                            "drained_clean")},
            "metrics": "singa_autoscale_ticks_total" in text}


def test_autoscaler_ticks_grow_and_drain_alike():
    got = both(_ticks)
    assert got["actions"] == ["up", "abort", "hold", "down", "hold"]
    assert got["names"][0] == ["e0", "e1"] and len(got["names"][-1]) == 1
    assert got["counts"]["scale_ups"] == 1 and got["metrics"]


# -- obs.collect ------------------------------------------------------------------

def _buf(process, pid, wall_origin_s, spans):
    evs = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": process}}]
    for name, sid, parent, ts, dur, trace, extra in spans:
        args = {"span_id": sid, "trace": trace}
        if parent:
            args["parent_id"] = parent
        args.update(extra)
        evs.append({"ph": "X", "cat": "obs", "name": name, "pid": pid,
                    "tid": 1, "ts": ts, "dur": dur, "args": args})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "process": process, "pid": pid, "wall_origin_s": wall_origin_s}


def _random_bufs(seed):
    rng = np.random.default_rng(seed)
    bufs, sid = [], 1
    for pid in range(1, 4):
        spans = []
        for _ in range(12):
            parent = int(rng.integers(0, sid)) if sid > 1 else 0
            spans.append((f"span{int(rng.integers(0, 5))}", sid, parent,
                          float(rng.uniform(0, 1e4)),
                          float(rng.uniform(1, 500)),
                          f"t{int(rng.integers(0, 3))}",
                          {"engine": f"e{pid}"}))
            sid += 1
        bufs.append(_buf(f"proc-{pid}", pid,
                         100.0 + float(rng.uniform(0, 0.01)), spans))
    return bufs + bufs[1:2]             # one buffer pulled twice


def _merged(pkg, seed):
    m = pkg.collect.merge(_random_bufs(seed))
    ids = pkg.collect.trace_ids(m)
    return {"merged": m, "ids": ids,
            "orphans": {t: pkg.collect.orphans(m, t) for t in ids},
            "paths": {t: pkg.collect.critical_path(m, t) for t in ids},
            "spans": {t: pkg.collect.spans_of(m, t) for t in ids}}


@pytest.mark.parametrize("seed", [0, 1])
def test_collect_merges_alike(seed):
    got = both(_merged, seed)
    xs = [e for e in got["merged"]["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 36 and got["ids"]


def test_trace_timeline_tool_renders_alike(tmp_path, capsys):
    import importlib.util
    import json
    import os
    from singa_tpu_torch.tools import trace_timeline as ttimeline
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "trace_timeline.py")
    spec = importlib.util.spec_from_file_location("trace_timeline_jax",
                                                  path)
    jtimeline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtimeline)
    merged = tmp_path / "merged.json"
    merged.write_text(json.dumps(tcollect.merge(_random_bufs(2))))
    out = {}
    for name, tool in (("jax", jtimeline), ("torch", ttimeline)):
        for argv in ([str(merged)], [str(merged), "--trace", "t1",
                                     "--top", "3"]):
            assert tool.main(argv) == 0
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert "critical path (self time, top 3)" in out["torch"]


# -- the traffic generator ------------------------------------------------------

def _traffic(pkg):
    lock = threading.Lock()
    calls = {"n": 0}

    def flaky(tokens, priority="interactive"):
        with lock:
            calls["n"] += 1
            n = calls["n"]
        if n % 3 == 1:
            raise pkg.serve.Overloaded("full", retry_after=0.01)
        if n % 3 == 2:
            raise ValueError("boom")

    gen = pkg.serve.TrafficGen(flaky, seed=3, **QUIET)
    phases = [pkg.serve.steady("a", duration_s=0.2, rate_rps=40.0,
                               priorities=("interactive", "batch"),
                               priority_weights=(0.5, 0.5)),
              pkg.serve.flash_crowd("b", duration_s=0.2, base_rps=20.0,
                                    k=2.0)]
    rep = gen.run(phases, drain_timeout_s=5.0)
    return rep


def test_traffic_accounts_every_offered_request():
    for name, pkg in PKGS.items():
        rep = _traffic(pkg)
        tot = rep["totals"]
        assert tot["offered"] == (tot["completed"] + tot["shed"]
                                  + tot["failed"]), (name, tot)
        assert tot["shed"] >= 1 and tot["failed"] >= 1
        assert tot["dropped_harness"] == 0
        for row in rep["phases"]:
            assert row["offered"] == (row["completed"] + row["shed"]
                                      + row["failed"]), (name, row)
    # the same seed offers the same arrivals in both packages
    j = [p["offered"] for p in _traffic(PKGS["jax"])["phases"]]
    t = [p["offered"] for p in _traffic(PKGS["torch"])["phases"]]
    assert j == t
