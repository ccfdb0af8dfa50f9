"""Adversarial open-loop traffic harness: scenario load generation.

"Handles heavy traffic" is a claim until a load generator can refute
it.  The critical property here is OPEN-LOOP arrivals: each request
fires at its Poisson-scheduled instant whether or not earlier requests
have completed.  A closed-loop client (issue → wait → issue) slows
down exactly when the server does, so measured latency self-limits
and overload is invisible; an open-loop generator keeps offering load,
which is what a million independent users do.

Scenarios compose from `Phase`s:

    steady(...)       constant-rate Poisson arrivals
    ramp(...)         rate sweeps linearly start→end (diurnal rise)
    flash_crowd(...)  a step to k× the base rate (the retweet moment)
    diurnal(...)      ramp up → plateau → ramp down, in one call

Each `Phase` also carries the request-shape mix — long-tail prompt
lengths and max_new choices with weights — plus a `stream_p` fraction
of streaming requests, an optional `slow_reader_s` per-token consumer
delay (the client on hotel wifi that holds a stream slot open), and
an `on_start` hook for chaos legs (kill an engine mid-ramp, or
`stall_chaos(...)` to turn one replica into a straggler), and a QoS
`priorities`/`priority_weights` mix for brownout legs — reports then
break offered/completed/shed/p95 down per class.

`TrafficGen.run(phases)` records, per phase and in total: offered vs
completed load, sheds (`Overloaded` — the server protecting itself,
not a failure), failures (everything else — always a bug), harness
drops (the `max_outstanding` safety cap; counted, never silent), and
p50/p95/p99 completion latency.  Completions are attributed to the
phase that OFFERED them, so a flash crowd's backlog can't launder its
latency into the decay phase.

The port's own copy of `singa_tpu/serve/traffic.py` (pure Python and
numpy there too).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import qos
from .batcher import Overloaded


@dataclass(frozen=True)
class Phase:
    """One scenario leg: an arrival process plus a request-shape mix.
    `rate_end_rps` turns the leg into a linear ramp; weights need not
    sum to 1 (normalized at sample time)."""
    name: str
    duration_s: float
    rate_rps: float
    rate_end_rps: Optional[float] = None
    prompt_lens: Tuple[int, ...] = (4, 8)
    prompt_weights: Optional[Tuple[float, ...]] = None
    max_new: Tuple[int, ...] = (4,)
    max_new_weights: Optional[Tuple[float, ...]] = None
    stream_p: float = 0.0          # fraction routed as streams
    slow_reader_s: float = 0.0     # per-token consumer stall (streams)
    priorities: Tuple[str, ...] = ("interactive",)   # QoS class mix
    priority_weights: Optional[Tuple[float, ...]] = None
    # multi-tenant mix: each arrival is attributed to one tenant id
    # (weights normalized at sample time, like the other mixes) and
    # the report breaks offered/completed/shed/p95 down per tenant —
    # the isolation gate's raw data
    tenants: Tuple[str, ...] = ("default",)
    tenant_weights: Optional[Tuple[float, ...]] = None
    on_start: Optional[Callable[[], None]] = None   # chaos hook

    def __post_init__(self):
        if float(self.duration_s) <= 0:
            raise ValueError(f"phase {self.name!r}: duration_s must "
                             f"be > 0")
        if float(self.rate_rps) <= 0:
            raise ValueError(f"phase {self.name!r}: rate_rps must "
                             f"be > 0")
        if not 0 <= float(self.stream_p) <= 1:
            raise ValueError(f"phase {self.name!r}: stream_p must be "
                             f"in [0, 1]")
        for p in self.priorities:
            if p not in qos.PRIORITIES:
                raise ValueError(f"phase {self.name!r}: unknown "
                                 f"priority {p!r} (want one of "
                                 f"{qos.PRIORITIES})")
        if not self.tenants:
            raise ValueError(f"phase {self.name!r}: tenants must "
                             f"name at least one tenant")
        if self.tenant_weights is not None and \
                len(self.tenant_weights) != len(self.tenants):
            raise ValueError(f"phase {self.name!r}: tenant_weights "
                             f"must match tenants "
                             f"({len(self.tenant_weights)} vs "
                             f"{len(self.tenants)})")

    def rate_at(self, frac: float) -> float:
        """Instantaneous arrival rate `frac` of the way through."""
        if self.rate_end_rps is None:
            return float(self.rate_rps)
        return float(self.rate_rps) + (
            float(self.rate_end_rps) - float(self.rate_rps)) * frac


# -- scenario builders ------------------------------------------------------

def steady(name: str, duration_s: float, rate_rps: float,
           **kw) -> Phase:
    return Phase(name=name, duration_s=duration_s, rate_rps=rate_rps,
                 **kw)


def ramp(name: str, duration_s: float, start_rps: float,
         end_rps: float, **kw) -> Phase:
    return Phase(name=name, duration_s=duration_s, rate_rps=start_rps,
                 rate_end_rps=end_rps, **kw)


def flash_crowd(name: str, duration_s: float, base_rps: float,
                k: float = 5.0, **kw) -> Phase:
    """A step to k× the base rate — the load a ramp-tuned fleet has
    not provisioned for yet."""
    return Phase(name=name, duration_s=duration_s,
                 rate_rps=base_rps * float(k), **kw)


def diurnal(base_rps: float, peak_rps: float, rise_s: float,
            plateau_s: float, fall_s: float, **kw) -> List[Phase]:
    return [ramp("diurnal-rise", rise_s, base_rps, peak_rps, **kw),
            steady("diurnal-plateau", plateau_s, peak_rps, **kw),
            ramp("diurnal-fall", fall_s, peak_rps, base_rps, **kw)]


# -- generator --------------------------------------------------------------

class _PhaseLog:
    def __init__(self, name: str):
        self.name = name
        self.offered = 0
        self.completed = 0
        self.shed = 0
        self.failed = 0
        self.dropped_harness = 0
        self.latencies: List[float] = []
        self.errors: List[str] = []
        # per-QoS-class attribution (the brownout gate's raw data)
        self.offered_by_class: Dict[str, int] = {}
        self.completed_by_class: Dict[str, int] = {}
        self.shed_by_class: Dict[str, int] = {}
        self.lat_by_class: Dict[str, List[float]] = {}
        # per-tenant attribution (the isolation gate's raw data)
        self.offered_by_tenant: Dict[str, int] = {}
        self.completed_by_tenant: Dict[str, int] = {}
        self.shed_by_tenant: Dict[str, int] = {}
        self.lat_by_tenant: Dict[str, List[float]] = {}
        # per-stream delivery audit (the failover exactly-once gate):
        # duplicate/out-of-order indices and spliced terminals seen by
        # the CLIENT side of the harness
        self.stream_resumed = 0
        self.stream_dup = 0
        self.stream_gap = 0


def stall_chaos(fleet, name: Optional[str] = None,
                stall_s: float = 0.25) -> Callable[[], None]:
    """Chaos `on_start` hook: latch a per-step decode stall onto one
    LOCAL engine (`InferenceEngine.set_stall`) — the slow-replica leg
    the hedging gate runs against.  With `name=None` the
    lexicographically LAST active member is stalled: the Router's
    least-loaded tie-break prefers earlier names, so the straggler
    keeps eating its share of traffic through load imbalance rather
    than winning every pick."""
    def hook():
        target = name
        if target is None:
            members = sorted(m["name"]
                             for m in fleet.router.members()
                             if not m.get("draining"))
            target = members[-1] if members else None
        if target is None:
            return
        eng = getattr(fleet.router.handle_for(target), "engine", None)
        if eng is None:
            raise RuntimeError(f"stall_chaos: {target!r} is not a "
                               f"local engine (no set_stall)")
        eng.set_stall(stall_s)
    return hook


def kill_chaos(fleet, name: Optional[str] = None,
               delay_s: float = 0.0) -> Callable[[], None]:
    """Chaos `on_start` hook: crash one LOCAL engine
    (`LocalEngineHandle.kill`) — the mid-stream failover leg runs
    against this.  With `name=None` the lexicographically FIRST
    active member dies (the Router's least-loaded tie-break prefers
    earlier names, so the victim is holding live streams when it
    goes).  `delay_s` arms the kill on a timer so streams admitted at
    phase start are mid-decode when it fires."""
    def hook():
        target = name
        if target is None:
            members = sorted(m["name"]
                             for m in fleet.router.members()
                             if not m.get("draining"))
            target = members[0] if members else None
        if target is None:
            return

        def kill():
            h = fleet.router.handle_for(target)
            if not hasattr(h, "kill"):
                raise RuntimeError(f"kill_chaos: {target!r} has no "
                                   f"kill() (not a local handle)")
            h.kill()
        if delay_s > 0:
            threading.Timer(float(delay_s), kill).start()
        else:
            kill()
    return hook


class TrafficGen:
    """Open-loop Poisson load against a fleet-shaped target.

    `request_fn(tokens)` runs one buffered request (e.g.
    `fleet.generate`); `stream_fn(tokens, max_new)` (optional) returns
    a token-event iterator (e.g. `fleet.generate_stream`).  Both may
    raise `Overloaded` (counted as shed) — anything else is a failure.
    `max_outstanding` bounds harness threads: an arrival past the cap
    is counted `dropped_harness`, never silently skipped — the report
    stays honest about the load actually offered."""

    def __init__(self, request_fn: Callable[[Any], Any],
                 stream_fn: Optional[Callable[..., Any]] = None,
                 vocab: int = 64, seed: int = 0,
                 max_outstanding: int = 512, log_fn=print):
        self.request_fn = request_fn
        self.stream_fn = stream_fn
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.max_outstanding = int(max_outstanding)
        self.log = log_fn
        self._lock = threading.Lock()
        self._outstanding = 0
        self._threads: List[threading.Thread] = []

    # -- one request --------------------------------------------------------
    def _sample(self, rng, choices, weights) -> int:
        if weights is None:
            return int(rng.choice(list(choices)))
        w = np.asarray(weights, dtype=np.float64)
        return int(rng.choice(list(choices), p=w / w.sum()))

    def _pick_priority(self, rng, phase: Phase) -> str:
        if len(phase.priorities) == 1:
            return phase.priorities[0]
        if phase.priority_weights is None:
            return str(rng.choice(list(phase.priorities)))
        w = np.asarray(phase.priority_weights, dtype=np.float64)
        return str(rng.choice(list(phase.priorities), p=w / w.sum()))

    def _pick_tenant(self, rng, phase: Phase) -> str:
        if len(phase.tenants) == 1:
            return phase.tenants[0]
        if phase.tenant_weights is None:
            return str(rng.choice(list(phase.tenants)))
        w = np.asarray(phase.tenant_weights, dtype=np.float64)
        return str(rng.choice(list(phase.tenants), p=w / w.sum()))

    def _fire(self, phase: Phase, log: _PhaseLog, rng_seed: int) -> None:
        rng = np.random.default_rng(rng_seed)
        plen = self._sample(rng, phase.prompt_lens,
                            phase.prompt_weights)
        mnew = self._sample(rng, phase.max_new, phase.max_new_weights)
        tokens = rng.integers(1, self.vocab, size=plen).astype(np.int32)
        as_stream = (self.stream_fn is not None
                     and rng.random() < float(phase.stream_p))
        pri = self._pick_priority(rng, phase)
        ten = self._pick_tenant(rng, phase)
        # Back-compat: plain `request_fn(tokens)` targets (tests wrap
        # bare lambdas) only see a kwarg when the phase actually
        # mixes classes/tenants — "interactive"/"default" is every
        # layer's default.
        kw: Dict[str, Any] = {} if pri == "interactive" \
            else {"priority": pri}
        if ten != "default":
            kw["tenant"] = ten
        with self._lock:
            log.offered_by_class[pri] = \
                log.offered_by_class.get(pri, 0) + 1
            log.offered_by_tenant[ten] = \
                log.offered_by_tenant.get(ten, 0) + 1
        t0 = time.monotonic()
        try:
            if as_stream:
                want_i = 0
                for ev in self.stream_fn(tokens, max_new=mnew, **kw):
                    if "token" in ev and not ev.get("done"):
                        i = int(ev.get("i", want_i))
                        if i < want_i:
                            with self._lock:
                                log.stream_dup += 1
                        elif i > want_i:
                            with self._lock:
                                log.stream_gap += 1
                            want_i = i + 1
                        else:
                            want_i += 1
                    elif ev.get("done") and ev.get("spliced"):
                        with self._lock:
                            log.stream_resumed += 1
                    if phase.slow_reader_s > 0 and "token" in ev:
                        time.sleep(phase.slow_reader_s)
            else:
                self.request_fn(tokens, **kw)
        except Overloaded:
            with self._lock:
                log.shed += 1
                log.shed_by_class[pri] = \
                    log.shed_by_class.get(pri, 0) + 1
                log.shed_by_tenant[ten] = \
                    log.shed_by_tenant.get(ten, 0) + 1
            return
        except Exception as e:  # noqa: BLE001 — non-shed failure
            with self._lock:
                log.failed += 1
                if len(log.errors) < 5:
                    log.errors.append(f"{type(e).__name__}: {e}")
            return
        lat = time.monotonic() - t0
        with self._lock:
            log.completed += 1
            log.latencies.append(lat)
            log.completed_by_class[pri] = \
                log.completed_by_class.get(pri, 0) + 1
            log.lat_by_class.setdefault(pri, []).append(lat)
            log.completed_by_tenant[ten] = \
                log.completed_by_tenant.get(ten, 0) + 1
            log.lat_by_tenant.setdefault(ten, []).append(lat)

    def _spawn(self, phase: Phase, log: _PhaseLog, seed: int) -> None:
        with self._lock:
            if self._outstanding >= self.max_outstanding:
                log.dropped_harness += 1
                return
            self._outstanding += 1
            log.offered += 1

        def run():
            try:
                self._fire(phase, log, seed)
            finally:
                with self._lock:
                    self._outstanding -= 1

        t = threading.Thread(target=run, daemon=True,
                             name=f"traffic-{phase.name}")
        self._threads.append(t)
        t.start()

    # -- the open loop ------------------------------------------------------
    def run(self, phases: Sequence[Phase],
            drain_timeout_s: float = 60.0) -> Dict[str, Any]:
        """Drive every phase in order, then wait (bounded) for the
        tail of in-flight requests.  Arrivals NEVER wait on
        completions — the defining open-loop property."""
        rng = np.random.default_rng(self.seed)
        logs: List[_PhaseLog] = []
        seq = 0
        for phase in phases:
            log = _PhaseLog(phase.name)
            logs.append(log)
            if phase.on_start is not None:
                try:
                    phase.on_start()
                except Exception as e:  # noqa: BLE001 — chaos hook
                    self.log(f"traffic: on_start hook for "
                             f"{phase.name!r} failed: {e}")
            t0 = time.monotonic()
            end = t0 + float(phase.duration_s)
            next_t = t0
            while True:
                now = time.monotonic()
                if next_t >= end:
                    break
                if next_t > now:
                    time.sleep(min(next_t - now, 0.05))
                    continue
                self._spawn(phase, log, self.seed + seq)
                seq += 1
                frac = (next_t - t0) / float(phase.duration_s)
                rate = max(phase.rate_at(frac), 1e-6)
                next_t += float(rng.exponential(1.0 / rate))
            self.log(f"traffic: phase {phase.name!r} offered "
                     f"{log.offered} over {phase.duration_s:.1f}s")
        deadline = time.monotonic() + float(drain_timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if self._outstanding == 0:
                    break
            time.sleep(0.02)
        with self._lock:
            undrained = self._outstanding
        if undrained:
            self.log(f"traffic: {undrained} request(s) still in "
                     f"flight after {drain_timeout_s}s drain")
        self._threads = [t for t in self._threads if t.is_alive()]
        return self._report(logs, phases)

    # -- reporting ----------------------------------------------------------
    @staticmethod
    def _quantile(lats: List[float], q: float) -> Optional[float]:
        if not lats:
            return None
        s = sorted(lats)
        return round(s[min(int(q * len(s)), len(s) - 1)] * 1e3, 3)

    def _by_class(self, log: _PhaseLog) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for pri in sorted(set(log.offered_by_class)
                          | set(log.shed_by_class)
                          | set(log.completed_by_class)):
            lats = log.lat_by_class.get(pri, [])
            out[pri] = {
                "offered": log.offered_by_class.get(pri, 0),
                "completed": log.completed_by_class.get(pri, 0),
                "shed": log.shed_by_class.get(pri, 0),
                "p95_ms": self._quantile(lats, 0.95),
            }
        return out

    def _by_tenant(self, log: _PhaseLog) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for ten in sorted(set(log.offered_by_tenant)
                          | set(log.shed_by_tenant)
                          | set(log.completed_by_tenant)):
            lats = log.lat_by_tenant.get(ten, [])
            out[ten] = {
                "offered": log.offered_by_tenant.get(ten, 0),
                "completed": log.completed_by_tenant.get(ten, 0),
                "shed": log.shed_by_tenant.get(ten, 0),
                "p95_ms": self._quantile(lats, 0.95),
            }
        return out

    def _report(self, logs: List[_PhaseLog],
                phases: Sequence[Phase]) -> Dict[str, Any]:
        out_phases = []
        tot = _PhaseLog("total")
        for log, phase in zip(logs, phases):
            with self._lock:
                lats = list(log.latencies)
                row = {
                    "name": log.name,
                    "duration_s": float(phase.duration_s),
                    "offered": log.offered,
                    "completed": log.completed,
                    "shed": log.shed,
                    "failed": log.failed,
                    "dropped_harness": log.dropped_harness,
                    "qps_offered": round(
                        log.offered / float(phase.duration_s), 3),
                    "qps_completed": round(
                        log.completed / float(phase.duration_s), 3),
                    "p50_ms": self._quantile(lats, 0.50),
                    "p95_ms": self._quantile(lats, 0.95),
                    "p99_ms": self._quantile(lats, 0.99),
                    "stream_resumed": log.stream_resumed,
                    "stream_dup": log.stream_dup,
                    "stream_gap": log.stream_gap,
                    "by_class": self._by_class(log),
                    "by_tenant": self._by_tenant(log),
                    "errors": list(log.errors),
                }
            out_phases.append(row)
            tot.offered += log.offered
            tot.completed += log.completed
            tot.shed += log.shed
            tot.failed += log.failed
            tot.dropped_harness += log.dropped_harness
            tot.stream_resumed += log.stream_resumed
            tot.stream_dup += log.stream_dup
            tot.stream_gap += log.stream_gap
            tot.latencies.extend(lats)
            tot.errors.extend(log.errors)
            with self._lock:
                for d_tot, d_log in (
                        (tot.offered_by_class, log.offered_by_class),
                        (tot.completed_by_class,
                         log.completed_by_class),
                        (tot.shed_by_class, log.shed_by_class),
                        (tot.offered_by_tenant,
                         log.offered_by_tenant),
                        (tot.completed_by_tenant,
                         log.completed_by_tenant),
                        (tot.shed_by_tenant, log.shed_by_tenant)):
                    for pri, n in d_log.items():
                        d_tot[pri] = d_tot.get(pri, 0) + n
                for pri, ls in log.lat_by_class.items():
                    tot.lat_by_class.setdefault(pri, []).extend(ls)
                for ten, ls in log.lat_by_tenant.items():
                    tot.lat_by_tenant.setdefault(ten, []).extend(ls)
        return {
            "phases": out_phases,
            "totals": {
                "offered": tot.offered,
                "completed": tot.completed,
                "shed": tot.shed,
                "failed": tot.failed,
                "dropped_harness": tot.dropped_harness,
                "shed_rate": round(
                    tot.shed / max(tot.offered, 1), 4),
                "p50_ms": self._quantile(tot.latencies, 0.50),
                "p95_ms": self._quantile(tot.latencies, 0.95),
                "p99_ms": self._quantile(tot.latencies, 0.99),
                "stream_resumed": tot.stream_resumed,
                "stream_dup": tot.stream_dup,
                "stream_gap": tot.stream_gap,
                "by_class": self._by_class(tot),
                "by_tenant": self._by_tenant(tot),
                "errors": tot.errors[:10],
            },
        }
