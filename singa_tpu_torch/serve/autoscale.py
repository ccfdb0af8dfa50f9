"""SLO-driven fleet autoscaler: fit capacity to the workload.

A fixed `--fleet N` is wrong twice a day: under a flash crowd the
Router sheds (capacity too small), and at night N−1 engines idle
(capacity too large).  The `AutoScaler` closes that loop with the
signals the serving tier already publishes — no new instrumentation,
just a control law over the windowed views:

    shed_rate    RouterStats.windowed() — requests shed / routed over
                 the last `window_s`; the most direct overload signal
    p95          RouterStats.windowed() p95 vs the `slo_p95_ms` budget
    queue depth  probed per-member depth summed over active members
    occupancy    per-engine ServeStats cb_slot_occupancy_recent (or
                 batch occupancy) — saturation BEFORE shedding starts
    lag          pipeline blessed→served lag (when running under
                 `PipelineController`) — a fleet too busy to promote
                 is not a fleet to shrink

Control law (one `tick()` every `tick_s`):

    UP    any pressure signal over its bound → `EngineFleet.grow()`:
          spawn + load + warmup-capture + reload-to-pinned-step all
          happen BEFORE the Router sees the new member — a cold
          engine must never eat live traffic.
    DOWN  only after `quiet_ticks` CONSECUTIVE quiet ticks (no sheds,
          p95 under `down_margin` × SLO, low occupancy, zero lag) —
          the hysteresis that stops flapping — and the victim drains
          through the Router's membership path: admissions stop
          immediately, in-flight work (held stream slots included)
          finishes, then the member retires.  The rollout canary is
          never picked as the victim.
    HOLD  pressure at `max_engines`, or quiet at `min_engines`, or
          inside the `Backoff`-escalated cooldown after any action.

`scale.decide` fault site: a faulted tick skips the decision entirely
(counted `decide_faults`, evented `scale.abort`) — fault injection can
never retire an engine.  Telemetry: `singa_autoscale_*` counters and
gauges via `register_into`, `scale.up` / `scale.down` / `scale.hold` /
`scale.abort` events, `scale.tick` spans (docs/OBSERVABILITY.md).

The port's own copy of `singa_tpu/serve/autoscale.py`, JAX-free there
too.  On the card a grow captures the new engine's CUDA graphs on the
scaler's thread while its siblings replay (captures are thread-local,
on a side stream: `core/step_graph.py`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import obs
from ..utils import faults


@dataclass(frozen=True)
class AutoScaleSpec:
    """`--autoscale_spec` grammar (the ServeSpec mold):
    comma/semicolon-separated `key=value`."""
    slo_p95_ms: float = 200.0     # the latency budget
    max_shed_rate: float = 0.02   # tolerated windowed shed fraction
    w_batch: float = 0.5          # batch-shed weight in the signal
    w_best_effort: float = 0.0    # best_effort-shed weight (default:
                                  # shedding best_effort is the plan,
                                  # not a reason to buy capacity)
    min_engines: int = 1
    max_engines: int = 4
    cooldown_s: float = 5.0       # Backoff base between actions
    window_s: float = 10.0        # signal sliding window
    tick_s: float = 0.25          # control-loop cadence
    down_margin: float = 0.5      # quiet iff p95 < margin * SLO
    queue_high: float = 4.0       # pressure iff depth > n * queue_high
    occ_high: float = 0.9         # pressure iff occupancy above this
    quiet_ticks: int = 3          # consecutive quiet ticks before DOWN
    drain_timeout_s: float = 30.0
    seed: int = 0

    def __post_init__(self):
        if int(self.min_engines) < 1:
            raise ValueError(f"min_engines must be >= 1, got "
                             f"{self.min_engines}")
        if int(self.max_engines) < int(self.min_engines):
            raise ValueError(
                f"max_engines ({self.max_engines}) must be >= "
                f"min_engines ({self.min_engines})")
        if float(self.slo_p95_ms) <= 0:
            raise ValueError(f"slo_p95_ms must be > 0, got "
                             f"{self.slo_p95_ms}")
        if float(self.window_s) <= 0 or float(self.tick_s) <= 0:
            raise ValueError("window_s and tick_s must be > 0")
        if float(self.cooldown_s) < 0:
            raise ValueError(f"cooldown_s must be >= 0, got "
                             f"{self.cooldown_s}")
        if not 0 < float(self.down_margin) < 1:
            raise ValueError(f"down_margin must be in (0, 1), got "
                             f"{self.down_margin}")
        if int(self.quiet_ticks) < 1:
            raise ValueError(f"quiet_ticks must be >= 1, got "
                             f"{self.quiet_ticks}")
        for name in ("w_batch", "w_best_effort"):
            if not 0 <= float(getattr(self, name)) <= 1:
                raise ValueError(f"{name} must be in [0, 1], got "
                                 f"{getattr(self, name)}")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "AutoScaleSpec":
        kw: Dict[str, Any] = {}
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in (spec or "").replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                key, sep, val = part.partition("=")
                key, val = key.strip(), val.strip()
                if not sep or key not in types:
                    raise ValueError(f"unknown key {key!r}")
                kw[key] = (float(val) if "float" in str(types[key])
                           else int(val))
            except ValueError as e:
                raise ValueError(f"bad autoscale spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


class AutoScaler:
    """See module docstring.  One daemon thread ticks every
    `spec.tick_s`; `tick()` is also callable directly (tests and the
    bench drive control timing deterministically).  Scale-up runs
    inline (the capture cost IS the action); scale-down drains on a
    background thread so a slow drain never freezes the control
    loop."""

    def __init__(self, fleet, spec: Optional[AutoScaleSpec] = None,
                 lag_fn=None, log_fn=print):
        self.fleet = fleet
        self.spec = spec or AutoScaleSpec()
        self.lag_fn = lag_fn         # () -> {"lag_steps": ...} or None
        self.log = log_fn
        self._backoff = faults.Backoff(base=max(self.spec.cooldown_s,
                                                1e-3),
                                       cap=max(self.spec.cooldown_s,
                                               1e-3) * 8,
                                       seed=self.spec.seed)
        self._cooldown_until = 0.0
        self._streak = 0             # same-direction actions in a row
        self._last_dir: Optional[str] = None
        self._quiet = 0              # consecutive quiet ticks
        self._busy = False           # one membership action at a time
        self._action_thread: Optional[threading.Thread] = None
        # outcome counters (snapshot / singa_autoscale_*)
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.holds = 0
        self.aborts = 0
        self.decide_faults = 0
        self.grow_failures = 0
        self.drained_clean = 0
        self.drain_timeouts = 0
        self.last_decision: str = "none"
        self.last_why: str = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AutoScaler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None
        t = self._action_thread
        if t is not None:
            t.join(self.spec.drain_timeout_s + 5.0)
            self._action_thread = None

    def _loop(self) -> None:
        while not self._stop.wait(float(self.spec.tick_s)):
            self.tick()

    # -- signals ------------------------------------------------------------
    def signals(self) -> Dict[str, Any]:
        """One coherent reading of every control input.  `n` counts
        ACTIVE members only — a draining engine is capacity already
        spent, not capacity to reason about.

        The shed signal is CLASS-WEIGHTED: an interactive shed counts
        1.0, a batch shed `w_batch`, a best_effort shed
        `w_best_effort` (default 0 — brownout shedding best_effort is
        the system working, not a reason to buy capacity).  The raw
        all-classes rate stays visible as `shed_rate_raw`.  p95 is the
        INTERACTIVE class p95 when that class has completions — the
        SLO is theirs; batch latency must not trigger scale-ups."""
        win = self.fleet.router.stats.windowed(self.spec.window_s)
        members = [m for m in self.fleet.router.members()
                   if not m.get("draining")]
        occ = None
        for m in members:
            if not m["healthy"] or m["quarantined"]:
                continue
            try:
                snap = self.fleet.router.handle_for(
                    m["name"]).stats_snapshot()
            except Exception:  # noqa: BLE001 — retired/dead mid-read
                continue
            v = snap.get("cb_slot_occupancy_recent")
            if v is None:
                v = snap.get("batch_occupancy")
            if v is not None:
                occ = v if occ is None else max(occ, v)
        lag_steps = 0
        if self.lag_fn is not None:
            try:
                lag_steps = int((self.lag_fn() or {}).get(
                    "lag_steps") or 0)
            except Exception:  # noqa: BLE001 — pipeline winding down
                lag_steps = 0
        by_class = win.get("shed_by_class") or {}
        weighted = (by_class.get("interactive", 0) * 1.0
                    + by_class.get("batch", 0)
                    * float(self.spec.w_batch)
                    + by_class.get("best_effort", 0)
                    * float(self.spec.w_best_effort))
        # TENANT-WEIGHTED on top of class-weighted: a shed charged to
        # a quota-limited tenant counts only `share` (its queue_frac)
        # of a shed from an unconstrained one — a tenant overflowing
        # its OWN entitlement is blast-radius containment working,
        # not a reason to buy fleet-wide capacity.  The discount is
        # the share-weighted mean over the window's sheds; with no
        # tenancy configured every share is 1.0 and the factor is 1.0
        # (legacy control law unchanged).
        tenant_factor = 1.0
        by_tenant = win.get("shed_by_tenant") or {}
        total_t = sum(by_tenant.values())
        reg = getattr(getattr(self.fleet, "router", None),
                      "tenancy", None)
        if total_t > 0 and reg is not None:
            tw = sum(cnt * float(reg.share(t))
                     for t, cnt in by_tenant.items())
            tenant_factor = tw / total_t
        weighted *= tenant_factor
        p95_cls = (win.get("p95_by_class") or {}).get("interactive")
        return {
            "n": len(members),
            "healthy": sum(1 for m in members
                           if m["healthy"] and not m["quarantined"]),
            "queue_depth": sum(m["queue_depth"] + m["in_flight"]
                               for m in members),
            "shed_rate": round(weighted / max(win["routed"], 1), 4),
            "shed_rate_raw": win["shed_rate"],
            "tenant_shed_factor": round(tenant_factor, 4),
            "qps": win["qps"],
            "p95_ms": (p95_cls if p95_cls is not None
                       else win["p95_latency_ms"]),
            "occupancy": occ,
            "lag_steps": lag_steps,
        }

    # -- control law --------------------------------------------------------
    def decide(self, sig: Dict[str, Any]) -> Dict[str, Any]:
        """Decision from one signal reading: {"dir": "up" | "down" |
        "hold", "why": ...}.  Touches nothing but the quiet-streak
        counter, so the control law is unit-testable on fabricated
        signals."""
        s = self.spec
        n = sig["n"]
        pressure: List[str] = []
        if sig["shed_rate"] > float(s.max_shed_rate):
            pressure.append(f"shed_rate {sig['shed_rate']:.3f} > "
                            f"{s.max_shed_rate}")
        if sig["p95_ms"] is not None and \
                sig["p95_ms"] > float(s.slo_p95_ms):
            pressure.append(f"p95 {sig['p95_ms']:.1f}ms > SLO "
                            f"{s.slo_p95_ms}ms")
        if sig["queue_depth"] > n * float(s.queue_high):
            pressure.append(f"queue depth {sig['queue_depth']} > "
                            f"{n} x {s.queue_high}")
        if sig["occupancy"] is not None and \
                sig["occupancy"] > float(s.occ_high):
            pressure.append(f"occupancy {sig['occupancy']:.2f} > "
                            f"{s.occ_high}")
        if pressure:
            self._quiet = 0
            if n >= int(s.max_engines):
                return {"dir": "hold",
                        "why": f"pressure at max_engines "
                               f"({'; '.join(pressure)})"}
            return {"dir": "up", "why": "; ".join(pressure)}
        quiet = (sig["shed_rate"] == 0
                 and (sig["p95_ms"] is None
                      or sig["p95_ms"] < float(s.slo_p95_ms)
                      * float(s.down_margin))
                 and (sig["occupancy"] is None
                      or sig["occupancy"] < float(s.occ_high) / 2)
                 and sig["lag_steps"] == 0)
        if not quiet:
            self._quiet = 0
            return {"dir": "hold", "why": "inside the SLO band"}
        self._quiet += 1
        if n <= int(s.min_engines):
            self._quiet = min(self._quiet, int(s.quiet_ticks))
            return {"dir": "hold", "why": "quiet at min_engines"}
        if self._quiet < int(s.quiet_ticks):
            return {"dir": "hold",
                    "why": f"quiet streak {self._quiet}/"
                           f"{s.quiet_ticks}"}
        return {"dir": "down",
                "why": f"{self._quiet} consecutive quiet ticks"}

    # -- one tick -----------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One control step; returns the action taken ("up", "down",
        "hold", "abort", or None while a previous action is still in
        flight).  A faulted or crashed tick skips the decision — it
        never spawns and NEVER retires an engine."""
        with self._lock:
            self.ticks += 1
            if self._busy:
                return None          # one membership action at a time
        try:
            with obs.span("scale.tick"):
                faults.maybe_fault("scale.decide")
                sig = self.signals()
                verdict = self.decide(sig)
        except Exception as e:  # noqa: BLE001 — skip, never kill
            with self._lock:
                self.decide_faults += 1
                self.aborts += 1
                self.last_decision, self.last_why = \
                    "abort", f"{type(e).__name__}: {e}"
            self.log(f"autoscale: tick aborted "
                     f"({type(e).__name__}: {e}); no decision taken")
            obs.emit_event("scale.abort",
                           why=f"{type(e).__name__}: {e}")
            return "abort"
        now = time.monotonic()
        if verdict["dir"] != "hold" and now < self._cooldown_until:
            with self._lock:
                self.holds += 1
                self.last_decision = "hold"
                self.last_why = (f"cooldown "
                                 f"({self._cooldown_until - now:.1f}s "
                                 f"left); wanted {verdict['dir']}: "
                                 f"{verdict['why']}")
            obs.emit_event("scale.hold", why=self.last_why,
                           wanted=verdict["dir"], n=sig["n"])
            return "hold"
        if verdict["dir"] == "hold":
            with self._lock:
                self.holds += 1
                self.last_decision, self.last_why = \
                    "hold", verdict["why"]
            return "hold"
        self._arm_cooldown(verdict["dir"])
        if verdict["dir"] == "up":
            return self._scale_up(sig, verdict["why"])
        return self._scale_down(sig, verdict["why"])

    def _arm_cooldown(self, direction: str) -> None:
        streak = (self._streak + 1 if direction == self._last_dir
                  else 0)
        self._streak, self._last_dir = streak, direction
        self._cooldown_until = time.monotonic() + \
            self._backoff.delay(streak)

    def _scale_up(self, sig: Dict[str, Any], why: str) -> str:
        with obs.span("scale.up", n=sig["n"]):
            try:
                name = self.fleet.grow()
            except Exception as e:  # noqa: BLE001 — keep serving at n
                with self._lock:
                    self.grow_failures += 1
                    self.aborts += 1
                    self.last_decision = "abort"
                    self.last_why = f"grow failed: {e}"
                self.log(f"autoscale: scale-up FAILED ({e}); fleet "
                         f"stays at {sig['n']}")
                obs.emit_event("scale.abort", why=f"grow failed: {e}",
                               n=sig["n"])
                return "abort"
        with self._lock:
            self.scale_ups += 1
            self.last_decision, self.last_why = "up", why
        self._quiet = 0
        self.log(f"autoscale: scaled UP to {sig['n'] + 1} "
                 f"(joined {name}): {why}")
        obs.emit_event("scale.up", engine=name, n=sig["n"] + 1,
                       why=why)
        return "up"

    def _pick_victim(self) -> Optional[str]:
        """Least valuable active member: quarantined engines first,
        then the least-loaded — and never the rollout canary (retiring
        it would abort a rollout just to save one engine)."""
        canary = (self.fleet.rollout.canary
                  if self.fleet.rollout is not None else None)
        cands = [m for m in self.fleet.router.members()
                 if not m.get("draining") and m["name"] != canary]
        if not cands:
            return None
        cands.sort(key=lambda m: (
            m["healthy"] and not m["quarantined"],   # sick first
            m["in_flight"] + m["queue_depth"]))      # then idle first
        return cands[0]["name"]

    def _scale_down(self, sig: Dict[str, Any], why: str) -> str:
        victim = self._pick_victim()
        if victim is None:
            with self._lock:
                self.holds += 1
                self.last_decision = "hold"
                self.last_why = "no retirable engine"
            obs.emit_event("scale.hold", why="no retirable engine",
                           n=sig["n"])
            return "hold"
        with self._lock:
            self._busy = True
        self._quiet = 0

        def drain():
            try:
                with obs.span("scale.down", engine=victim,
                              n=sig["n"]):
                    drained = self.fleet.retire(
                        victim, drain=True,
                        timeout_s=self.spec.drain_timeout_s)
                with self._lock:
                    self.scale_downs += 1
                    if drained:
                        self.drained_clean += 1
                    else:
                        self.drain_timeouts += 1
                    self.last_decision, self.last_why = "down", why
                self.log(f"autoscale: scaled DOWN to {sig['n'] - 1} "
                         f"(retired {victim}, "
                         f"{'drained' if drained else 'drain timed out'}"
                         f"): {why}")
                obs.emit_event("scale.down", engine=victim,
                               n=sig["n"] - 1, drained=drained,
                               why=why)
            finally:
                with self._lock:
                    self._busy = False

        t = threading.Thread(target=drain, name="fleet-scale-down",
                             daemon=True)
        self._action_thread = t
        t.start()
        return "down"

    # -- durable control state (fleet state provider) ------------------------
    def export_state(self) -> Dict[str, Any]:
        """What a reborn autoscaler must remember: the cooldown still
        in force (as remaining seconds — monotonic clocks don't
        survive a restart) and the same-direction streak that sized
        it.  Without this a crash-restart forgets the cooldown and
        can oscillate immediately — the exact flap damping exists to
        prevent."""
        with self._lock:
            rem = max(self._cooldown_until - time.monotonic(), 0.0)
            return {"cooldown_remaining_s": round(rem, 3),
                    "streak": self._streak,
                    "last_dir": self._last_dir}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            rem = float(state.get("cooldown_remaining_s", 0.0))
            if rem > 0:
                self._cooldown_until = time.monotonic() + rem
            self._streak = max(int(state.get("streak", 0)), 0)
            last = state.get("last_dir")
            self._last_dir = str(last) if last is not None else None

    # -- reads --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {"ticks": self.ticks,
                   "scale_ups": self.scale_ups,
                   "scale_downs": self.scale_downs,
                   "holds": self.holds,
                   "aborts": self.aborts,
                   "decide_faults": self.decide_faults,
                   "grow_failures": self.grow_failures,
                   "drained_clean": self.drained_clean,
                   "drain_timeouts": self.drain_timeouts,
                   "last_decision": self.last_decision,
                   "last_why": self.last_why,
                   "busy": self._busy}
        out["engines"] = len([m for m in self.fleet.router.members()
                              if not m.get("draining")])
        out["quiet_streak"] = self._quiet
        return out

    def register_into(self, registry,
                      prefix: str = "singa_autoscale") -> None:
        from ..obs.metrics import Sample

        counters = ("ticks", "scale_ups", "scale_downs", "holds",
                    "aborts", "decide_faults", "grow_failures",
                    "drained_clean", "drain_timeouts")

        def collect():
            snap = self.snapshot()
            out = [Sample(f"{prefix}_{k}_total", "counter",
                          f"autoscaler counter {k!r}", float(snap[k]))
                   for k in counters]
            out += [Sample(f"{prefix}_{k}", "gauge",
                           f"autoscaler gauge {k!r}", float(snap[k]))
                    for k in ("engines", "quiet_streak")]
            return out

        registry.register_collector(collect)
