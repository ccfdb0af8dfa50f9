"""Fault-tolerant serving fleet: N engine workers behind a `Router`,
with rolling checkpoint rollout (canary → promote / auto-rollback).

`EngineFleet` spawns (in-process threads — the CPU-test and
single-machine shape) or adopts (subprocesses over HTTP, membership
from `parallel.bootstrap.parse_hostfile`) N engine workers, pins each
engine's fingerprint (no self-reload), and fronts them with a
`Router` (router.py: least-loaded healthy dispatch, quarantine/
readmission, retry-on-other-engine, router-level shedding).

The rollout state machine (`RolloutController`) closes the loop the
single-engine tier could not: a new checkpoint fingerprint is never
trusted fleet-wide.

    OBSERVE   poll `CheckpointManager.fingerprint()` (two stats, no
              reads).  A new latest step that is neither the pinned
              step nor an already-rejected fingerprint starts a
              canary.
    CANARY    exactly ONE engine (the least-loaded healthy one)
              reloads to the target step — deliberately WITHOUT the
              healthy-verdict walk-back: the canary exists to absorb
              the blast radius, so a DIVERGED or torn snapshot can
              never touch more than 1/N of traffic.  A reload that
              fails or lands elsewhere (torn target) is a counted
              refusal: the fleet never serves the fingerprint at all.
              While canarying: the canary dying / getting quarantined
              rolls back immediately (never a deadlock), and a NEWER
              fingerprint landing on disk aborts and restarts the
              canary on the newest step (stale canaries are wasted
              blast radius).
    PROMOTE   after `window_s` of canary traffic, promote fleet-wide
              only if the manifest health verdict is ok AND the
              canary's own health held AND its error rate and p95
              stayed within tolerance of the pre-canary window.
              Remaining engines reload one at a time (rolling — the
              fleet keeps serving throughout).
    ROLLBACK  any failed gate reloads the canary back to the pinned
              step and records the fingerprint as rejected (not
              re-canaried every poll; a new save changes it again).

Fault sites: `fleet.dispatch` (router attempt — behaves exactly like
an engine failure), `fleet.rollout` (controller tick — aborts the
rollout safely: rollback, never promote).  Events: `fleet.canary`,
`fleet.promote`, `fleet.rollback`, `fleet.quarantine`,
`fleet.readmit`, `fleet.join`, `fleet.retire`, `fleet.canary_abort`
(docs/OBSERVABILITY.md).

Membership is elastic (autoscale.py): `EngineFleet.grow()` spawns a
warmed, pinned worker and only then shows it to the Router;
`EngineFleet.retire(name, drain=True)` stops admissions, lets
in-flight work (including held stream slots) finish, then drops the
member.  A canary retired mid-rollout ABORTS the canary (counted as
`canary_aborts`, never a rollback) and the unjudged step re-canaries
on a survivor.

The port's own copy of `singa_tpu/serve/fleet.py`.  In-process members
are the port's engines on `device` (the card unless the caller asks for
the CPU); each owns its params (a copy when the caller's tensors are
already on its device), so a canary's reload moves one engine only.
Members warm up generate and predict by default, as the port's
`InferenceServer` does, so no capture runs on a serving thread; a grow
captures the new member's graphs on the caller's thread while its
siblings replay.  A retired member's graphs, pools and params are freed
when the last reference to its handle drops.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import obs
from ..utils import faults
from ..utils.checkpoint import CheckpointManager
from .engine import InferenceEngine, ServeSpec
from . import wire
from .router import (LameDuck, LocalEngineHandle, Router, RouterSpec,
                     HttpEngineHandle, UnknownSession, _handle_call)
from .server import InferenceServer
from .wire import NegotiatingEngineHandle
from .sessionlog import (ControlStateStore, SessionWal, WalStats,
                         claim_epoch, latest_wal_before, reduce_sessions,
                         replay_wal)
from .tenancy import TenantRegistry


@dataclass(frozen=True)
class RolloutSpec:
    """`--rollout_spec` grammar (ServeSpec mold): comma/semicolon-
    separated `key=value`."""
    poll_s: float = 0.25         # fingerprint poll cadence
    window_s: float = 1.0        # canary observation window
    min_requests: int = 0        # canary traffic wanted before verdict
    max_extends: int = 2         # extra windows waiting for traffic
    err_tolerance: float = 0.05  # canary err-rate − baseline bound
    p95_ratio: float = 3.0       # canary p95 / baseline p95 bound
    seed: int = 0

    def __post_init__(self):
        if float(self.poll_s) <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")
        if float(self.window_s) <= 0:
            raise ValueError(f"window_s must be > 0, got "
                             f"{self.window_s}")
        if float(self.p95_ratio) <= 0:
            raise ValueError(f"p95_ratio must be > 0, got "
                             f"{self.p95_ratio}")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "RolloutSpec":
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
                raise ValueError(f"bad rollout spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


class RolloutController:
    """The OBSERVE→CANARY→PROMOTE/ROLLBACK state machine (module
    docstring).  One daemon thread ticks every `spec.poll_s`; every
    transition is counted, logged, and evented."""

    def __init__(self, router: Router, workspace: str,
                 spec: Optional[RolloutSpec] = None, log_fn=print,
                 family: Optional[str] = None):
        self.router = router
        self.spec = spec or RolloutSpec()
        self.log = log_fn
        # scope this controller to ONE checkpoint family: its canary
        # lands on a member of that family and promotion touches only
        # that family's members.  None = whole fleet (the legacy
        # single-family shape)
        self.family = family
        self.mgr = CheckpointManager(workspace, log_fn=lambda s: None)
        self.state = "OBSERVE"
        self.pinned_step: int = -1
        self.target_step: Optional[int] = None
        self.canary: Optional[str] = None       # engine name
        self._fp: Optional[tuple] = None
        self._rejected_fp: Optional[tuple] = None
        self._deadline: float = 0.0
        self._extends: int = 0
        self._pre: Dict[str, Any] = {}          # canary stats pre-reload
        self._baseline_p95: Optional[float] = None
        self._t_live = 0.0          # when the canary went live
        # outcome counters (fleet snapshot / BENCH_pr7.json)
        self.canaries = 0
        self.canary_restarts = 0
        self.promotions = 0
        self.rollbacks = 0
        self.refusals = 0
        self.canary_aborts = 0   # canary engine retired mid-canary
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self, pinned_step: int) -> "RolloutController":
        self.pinned_step = int(pinned_step)
        # deliberately NOT pre-capturing the fingerprint: a checkpoint
        # that landed between the engines loading and this start() would
        # otherwise be invisible forever (fingerprint unchanged from
        # here on, so OBSERVE never fires — the general form of the
        # fleet-pinned-at--1 startup race).  With _fp = None the first
        # tick always compares the latest step against the pinned one.
        self._fp = None
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-rollout",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(float(self.spec.poll_s)):
            self.tick()

    # -- one tick -----------------------------------------------------------
    def tick(self) -> None:
        """One state-machine step (also callable directly: tests and
        the bench drive rollout timing deterministically).  An
        injected `fleet.rollout` fault — or any unexpected controller
        error — aborts the rollout SAFELY: mid-canary it rolls back,
        and the fleet never promotes on a faulted tick."""
        with self._lock:
            try:
                faults.maybe_fault("fleet.rollout")
                if self.state == "OBSERVE":
                    self._tick_observe()
                elif self.state == "CANARY":
                    self._tick_canary()
            except Exception as e:  # noqa: BLE001 — degrade, never die
                self.log(f"warning: rollout tick failed "
                         f"({type(e).__name__}: {e})"
                         + ("; rolling canary back"
                            if self.state == "CANARY" else ""))
                if self.state == "CANARY":
                    self._rollback(f"rollout fault: {e}")

    def _tick_observe(self) -> None:
        fp = self.mgr.fingerprint()
        if fp == self._fp and self.target_step is None:
            return
        self._fp = fp
        if fp == self._rejected_fp:
            return                 # already judged and rolled back
        target = self.mgr.latest_step()
        if target is None or target == self.pinned_step:
            return
        self._begin_canary(target)

    def _begin_canary(self, target: int) -> None:
        name = self.router.pick_canary(family=self.family)
        if name is None:
            # no healthy engine to canary on — remember the target and
            # retry next tick rather than wedging
            self.target_step = target
            return
        self.target_step = target
        try:
            handle = self.router.handle_for(name)
        except KeyError:
            # picked engine retired between pick and use (autoscale
            # scale-down race) — remember the target, retry next tick
            return
        pre = self._engine_counts(handle)
        self._baseline_p95 = self.router.stats.latency_quantile(0.95)
        with obs.span("fleet.rollout", phase="canary", engine=name,
                      target=target) as fsp:
            try:
                # reload hop carries the rollout span's trace context
                # (_handle_call drops it for handles without the kwarg)
                got = _handle_call(
                    handle.reload, (),
                    {"step": target,
                     "trace": ((fsp.trace, fsp.span_id)
                               if fsp.trace else None)})
            except Exception as e:  # noqa: BLE001 — engine died on us
                got = {"outcome": "failed", "step": -1,
                       "error": str(e)}
        if got.get("outcome") not in ("reloaded", "unchanged") or \
                int(got.get("step", -1)) != target:
            # the target never made it onto ANY engine (failed/refused
            # reload, or a torn snapshot the restore walked back past)
            self.refusals += 1
            self._rejected_fp = self._fp
            self.target_step = None
            self.log(f"fleet: rollout to step {target} refused on "
                     f"canary {name} ({got.get('outcome')}, landed "
                     f"step {got.get('step')}); fleet stays on "
                     f"step {self.pinned_step}")
            obs.emit_event("fleet.rollback", engine=name,
                           target=target, why="canary reload refused",
                           outcome=str(got.get("outcome")))
            # belt and braces: make sure the canary still serves the
            # pinned params (a failed reload never unseats them, but a
            # walk-back may have landed elsewhere)
            self._restore_canary(name)
            return
        self.canaries += 1
        self.canary = name
        self.state = "CANARY"
        self._pre = pre
        self._t_live = time.monotonic()
        self._deadline = self._t_live + float(self.spec.window_s)
        self._extends = 0
        self.log(f"fleet: canarying checkpoint step {target} on "
                 f"engine {name} (fleet pinned at "
                 f"{self.pinned_step})")
        obs.emit_event("fleet.canary", engine=name, target=target,
                       pinned=self.pinned_step)

    def _tick_canary(self) -> None:
        # newest-wins: a fresher fingerprint mid-canary restarts the
        # canary on the newest step (finishing a stale canary would
        # just delay the real rollout)
        fp = self.mgr.fingerprint()
        if fp != self._fp:
            self._fp = fp
            newest = self.mgr.latest_step()
            if newest is not None and newest != self.target_step and \
                    fp != self._rejected_fp:
                self.canary_restarts += 1
                name, old = self.canary, self.target_step
                self.log(f"fleet: newer checkpoint step {newest} "
                         f"landed mid-canary (was canarying {old}); "
                         f"restarting canary on the newest")
                self._restore_canary(name)
                self.state = "OBSERVE"
                self.canary = None
                self._begin_canary(newest)
                return
        mem = {m["name"]: m for m in self.router.members()}
        m = mem.get(self.canary)
        # canary deliberately retired (autoscale scale-down): the
        # checkpoint was never judged, so this is an ABORT, not a
        # rollback — the fingerprint stays eligible and re-canaries
        # on a surviving engine next tick
        if m is None or m.get("draining"):
            self._abort_canary("canary engine retired mid-canary")
            return
        # canary death / quarantine: roll back, never deadlock
        if m["quarantined"] or not m["healthy"]:
            self._rollback("canary engine died or degraded "
                           "mid-canary")
            return
        if time.monotonic() < self._deadline:
            return
        self._evaluate()

    def _engine_counts(self, handle) -> Dict[str, Any]:
        try:
            snap = handle.stats_snapshot()
        except Exception:  # noqa: BLE001 — dead engine: empty counts
            snap = {}
        return {"completed": int(snap.get("completed", 0)),
                "failed": int(snap.get("failed", 0)),
                "expired": int(snap.get("expired", 0))}

    def _evaluate(self) -> None:
        """The promotion gate: manifest verdict + canary health +
        error rate + p95, all against the pre-canary window."""
        name, target = self.canary, self.target_step
        try:
            handle = self.router.handle_for(name)
        except KeyError:
            self._abort_canary("canary engine retired at evaluation")
            return
        post = self._engine_counts(handle)
        served = post["completed"] - self._pre["completed"]
        if served < int(self.spec.min_requests) and \
                self._extends < int(self.spec.max_extends):
            # not enough canary traffic to judge yet — extend the
            # window a bounded number of times, then judge anyway
            self._extends += 1
            self._deadline = time.monotonic() + \
                float(self.spec.window_s)
            return
        reasons = []
        verdict = self.mgr.health_verdict(target)
        if verdict is not None and verdict != "ok":
            reasons.append(f"manifest health verdict {verdict!r}")
        mem = {m["name"]: m for m in self.router.members()}
        m = mem.get(name)
        if m is None or m["quarantined"] or not m["healthy"]:
            reasons.append("canary engine unhealthy at evaluation")
        errs = (post["failed"] - self._pre["failed"]) + \
            (post["expired"] - self._pre["expired"])
        err_rate = errs / max(served + errs, 1)
        if err_rate > float(self.spec.err_tolerance):
            reasons.append(f"canary error rate {err_rate:.3f} > "
                           f"{self.spec.err_tolerance}")
        # the canary's p95 over the requests it served in its own
        # window, as the router sees them (the baseline's side): its
        # latencies from before the reload say nothing of the
        # checkpoint (fault C7)
        p95 = self.router.stats.engine_latency_quantile(0.95, name,
                                                        self._t_live)
        base = self._baseline_p95
        if p95 is not None and base and \
                p95 > base * float(self.spec.p95_ratio):
            reasons.append(f"canary p95 {p95 * 1e3:.1f}ms > "
                           f"{self.spec.p95_ratio}x baseline "
                           f"{base * 1e3:.1f}ms")
        if reasons:
            self._rollback("; ".join(reasons))
        else:
            self._promote(served)

    def _promote(self, served: int) -> None:
        name, target = self.canary, self.target_step
        failures = []
        with obs.span("fleet.rollout", phase="promote",
                      target=target) as fsp:
            for other in self.router.names():
                if other == name:
                    continue
                if self.family is not None and \
                        self.router.engine_family(other) != \
                        self.family:
                    continue       # another family's member: not ours
                try:
                    handle = self.router.handle_for(other)
                    got = _handle_call(
                        handle.reload, (),
                        {"step": target,
                         "trace": ((fsp.trace, fsp.span_id)
                                   if fsp.trace else None)})
                except KeyError:
                    continue           # retired mid-promote: skip
                except Exception as e:  # noqa: BLE001 — router will
                    got = {"outcome": "failed", "error": str(e)}
                if got.get("outcome") not in ("reloaded", "unchanged"):
                    # quarantine/degrade machinery picks this engine
                    # up; the rollout itself still promotes
                    failures.append((other, got.get("outcome")))
        self.promotions += 1
        self.pinned_step = target
        self._rejected_fp = None
        # `_fp` stays the fingerprint this tick began from: a save that
        # landed while the siblings reloaded is new to the next tick
        # (fault C9)
        self.state = "OBSERVE"
        self.canary = None
        self.target_step = None
        self.log(f"fleet: promoted checkpoint step {target} "
                 f"fleet-wide (canary {name} served {served} "
                 f"request(s))"
                 + (f"; reload failed on {failures}" if failures
                    else ""))
        obs.emit_event("fleet.promote", target=target, canary=name,
                       canary_served=served,
                       failed_members=[f[0] for f in failures])

    def _rollback(self, why: str) -> None:
        name, target = self.canary, self.target_step
        self._rejected_fp = self._fp
        self.state = "OBSERVE"
        self.canary = None
        self.target_step = None
        self.log(f"fleet: ROLLBACK of checkpoint step {target} "
                 f"(canary {name}): {why}; fleet stays on step "
                 f"{self.pinned_step}")
        self._restore_canary(name)
        # counted only once the canary is back on the pinned step (or
        # confirmed dead): `rollbacks` means "rollback COMPLETED", so
        # an observer never reads it while the bad step still serves
        self.rollbacks += 1
        obs.emit_event("fleet.rollback", engine=name, target=target,
                       why=why, pinned=self.pinned_step)

    def _abort_canary(self, why: str) -> None:
        """The canary engine was deliberately retired out from under
        the rollout.  The checkpoint was never judged, so nothing is
        rejected and no rollback is counted — clear the state and the
        remembered fingerprint so OBSERVE re-canaries the same step on
        a surviving engine next tick."""
        name, target = self.canary, self.target_step
        self.state = "OBSERVE"
        self.canary = None
        self.target_step = None
        self._fp = None            # force OBSERVE to re-compare
        self.canary_aborts += 1
        self.log(f"fleet: canary of step {target} ABORTED "
                 f"(engine {name}: {why}); step stays eligible and "
                 f"re-canaries on a surviving engine")
        self._restore_canary(name)  # best-effort; gone engine = no-op
        obs.emit_event("fleet.canary_abort", engine=name,
                       target=target, why=why)

    def _restore_canary(self, name: Optional[str]) -> None:
        """Put the (possibly dead) canary back on the pinned step —
        best-effort: a dead engine is already quarantined and will be
        re-pinned by readmission-time reload if needed.  A pinned step
        of -1 (cold start: nothing ever promoted) restores the canary
        to its fresh-init params via `reload(step=-1)` — without it a
        rejected FIRST checkpoint would keep serving on the canary."""
        if name is None or name not in self.router.names():
            return                 # retired: nothing left to restore
        try:
            _handle_call(self.router.handle_for(name).reload, (),
                         {"step": self.pinned_step,
                          "trace": obs.trace_context()})
        except Exception as e:  # noqa: BLE001 — dead canary
            self.log(f"fleet: could not restore canary {name} to "
                     f"pinned step {self.pinned_step} ({e}); it "
                     f"stays quarantined until it recovers")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state,
                    "pinned_step": self.pinned_step,
                    "target_step": self.target_step,
                    "canary": self.canary,
                    "canaries": self.canaries,
                    "canary_restarts": self.canary_restarts,
                    "promotions": self.promotions,
                    "rollbacks": self.rollbacks,
                    "refusals": self.refusals,
                    "canary_aborts": self.canary_aborts,
                    "torn_polls": self.mgr.torn_polls}

    # -- durable control state (sessionlog.ControlStateStore) ---------------
    def export_state(self) -> Dict[str, Any]:
        """The rollout decisions that must survive a router restart:
        the pinned step (what the fleet serves) and the rejected
        fingerprint (a judged-and-rolled-back checkpoint must not be
        re-canaried by the reborn router)."""
        with self._lock:
            return {"pinned_step": self.pinned_step,
                    "rejected_fp": (list(self._rejected_fp)
                                    if self._rejected_fp is not None
                                    else None)}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            pinned = state.get("pinned_step")
            if pinned is not None and int(pinned) >= 0:
                self.pinned_step = int(pinned)
            fp = state.get("rejected_fp")
            if fp is not None:
                self._rejected_fp = tuple(fp)


class EngineFleet:
    """N engine workers + router + rollout controller, owned together.
    Build with `EngineFleet.local(...)` (in-process workers) or
    `EngineFleet.adopt(...)` / `EngineFleet.from_hostfile(...)`
    (subprocess workers over HTTP), then `start()`/`stop()` or use as
    a context manager.  `generate`/`predict` route through the fleet
    exactly as `FleetServer`'s HTTP frontend does."""

    def __init__(self, handles: List[Any],
                 workspace: Optional[str] = None,
                 router_spec: Optional[RouterSpec] = None,
                 rollout_spec: Optional[RolloutSpec] = None,
                 tenancy: Optional[TenantRegistry] = None,
                 standby: bool = False, log_fn=print):
        self.log = log_fn
        self.tenancy = tenancy if tenancy is not None \
            else TenantRegistry()
        self.router = Router(handles, spec=router_spec, log_fn=log_fn,
                             tenancy=self.tenancy)
        self.rollout: Optional[RolloutController] = (
            RolloutController(self.router, workspace,
                              spec=rollout_spec, log_fn=log_fn)
            if workspace else None)
        self._local = [h for h in handles
                       if isinstance(h, LocalEngineHandle)]
        # autoscale support: `local()` stashes what it would take to
        # spawn one more identical worker; adopted (HTTP) fleets can't
        # grow from here (spawning remote processes is deployment's
        # job, not the autoscaler's)
        self._spawn_cfg: Optional[Dict[str, Any]] = None
        self._next_idx = len(handles)
        self._grow_lock = threading.Lock()
        # -- crash-safe control plane (sessionlog.py) -------------------
        # a standby holds OFF claiming an epoch: claiming fences the
        # live primary's WAL, which is exactly the handoff and must
        # only happen at promote_standby()
        self.workspace = workspace
        self.standby = bool(standby)
        self.epoch = 0
        self.wal: Optional[SessionWal] = None
        self.wal_stats = WalStats()
        self._state_store: Optional[ControlStateStore] = None
        self.recovered_state: Dict[str, Any] = {}
        # extra durable-state providers (autoscaler etc.): name ->
        # (export_fn, restore_fn); restore happens at recover() time
        # for providers registered before start(), else via
        # `recovered_state`
        self._state_providers: Dict[str, Any] = {}
        self._snap_stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        if not self.standby:
            self._init_durability()

    # -- crash-safe control plane -------------------------------------------
    def _router_dir(self) -> Optional[str]:
        if not self.workspace:
            return None
        return os.path.join(self.workspace, "router")

    def _init_durability(self) -> None:
        """Claim the next epoch and open this router's WAL.  Claiming
        bumps `<ws>/router/EPOCH`, which self-fences any older router
        still appending to the shared workspace (SessionWal.flush
        re-reads the file) — restart and handoff share one mechanism."""
        dir_ = self._router_dir()
        if dir_ is None or self.router.spec.wal != "on":
            return
        try:
            self.epoch = claim_epoch(dir_)
            self.wal = SessionWal(
                dir_, self.epoch,
                group_tokens=self.router.spec.wal_group_tokens,
                group_ms=self.router.spec.wal_group_ms,
                stats=self.wal_stats, log_fn=self.log)
            self._state_store = ControlStateStore(
                dir_, stats=self.wal_stats)
            self.router.attach_wal(self.wal, self.epoch)
            self.log(f"fleet: session WAL on under epoch "
                     f"{self.epoch} ({dir_})")
        except Exception as e:  # noqa: BLE001 — durability is an
            # add-on: a broken disk degrades to the pre-WAL fleet,
            # counted, never a refusal to serve
            self.wal_stats.count("wal_lost")
            self.log(f"warning: could not open session WAL in "
                     f"{dir_} ({type(e).__name__}: {e}); serving "
                     f"without control-plane durability")
            self.wal = None

    def add_state_provider(self, name: str, export_fn,
                           restore_fn=None) -> None:
        """Register an extra durable-state contributor (e.g. the
        autoscaler's cooldown/streak).  If recovery already ran, the
        provider's slice is in `recovered_state` — restore it now."""
        self._state_providers[name] = (export_fn, restore_fn)
        got = self.recovered_state.get(name)
        if got is not None and restore_fn is not None:
            try:
                restore_fn(got)
            except Exception as e:  # noqa: BLE001
                self.log(f"warning: restoring {name} state failed "
                         f"({e}); starting fresh")

    def export_control_state(self) -> Dict[str, Any]:
        """Everything the next epoch needs that is NOT in the WAL:
        quarantine strikes/benches, shed streaks, rollout pin +
        rejected fingerprint, and any registered provider's slice."""
        state: Dict[str, Any] = {"epoch": self.epoch,
                                 "wall": round(time.time(), 3)}
        state["router"] = self.router.export_control_state()
        if self.rollout is not None:
            state["rollout"] = self.rollout.export_state()
        for name, (export_fn, _r) in self._state_providers.items():
            try:
                state[name] = export_fn()
            except Exception:  # noqa: BLE001 — a provider's failure
                pass           # must not sink the whole snapshot
        return state

    def _snapshot_loop(self) -> None:
        period = float(self.router.spec.state_snapshot_s)
        while not self._snap_stop.wait(period):
            if self._state_store is not None:
                self._state_store.save(self.export_control_state())

    def recover(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Replay the previous epoch's control snapshot and session
        WAL: restore quarantine/rollout/shed-streak state, then
        re-admit every non-terminal journaled stream through the
        durable-session resume path (pinned to the journaled
        fingerprint).  Clients reconnect with X-Session-Id and splice
        exactly-once; a fingerprint-gone stream finishes
        `failover_stale` with the journaled prefix."""
        summary = {"epoch": self.epoch, "state_restored": False,
                   "wal_replayed": None, "torn_tail": False,
                   "sessions": 0, "terminal": 0, "recovered": 0,
                   "failed": 0}
        dir_ = self._router_dir()
        if dir_ is None or self.wal is None:
            return summary
        try:
            faults.maybe_fault("router.recover")
            if self._state_store is not None:
                state = self._state_store.load()
                if state is not None:
                    self.router.restore_control_state(
                        state.get("router") or {})
                    if self.rollout is not None and \
                            state.get("rollout"):
                        self.rollout.restore_state(state["rollout"])
                    self.recovered_state = state
                    for name, (_e, restore_fn) in \
                            self._state_providers.items():
                        if restore_fn is not None and \
                                state.get(name) is not None:
                            restore_fn(state[name])
                    summary["state_restored"] = True
            prev = latest_wal_before(dir_, self.epoch)
            if prev is not None:
                header, records, torn = replay_wal(prev)
                if torn:
                    self.wal_stats.count("torn_tails")
                reduced = reduce_sessions(records)
                for _ in reduced:
                    self.wal_stats.count("replayed_sessions")
                got = self.router.recover_sessions(reduced,
                                                   timeout=timeout)
                for _ in range(int(got.get("recovered", 0))):
                    self.wal_stats.count("recovered_streams")
                summary.update(
                    wal_replayed=os.path.basename(prev),
                    torn_tail=bool(torn), sessions=len(reduced),
                    **{k: int(got.get(k, 0))
                       for k in ("terminal", "recovered", "failed")})
        except Exception as e:  # noqa: BLE001 — a broken replay must
            # never stop the fleet from serving NEW traffic
            self.log(f"warning: control-plane recovery failed "
                     f"({type(e).__name__}: {e}); serving without "
                     f"replayed state")
            summary["error"] = f"{type(e).__name__}: {e}"
        if summary["wal_replayed"] or summary["state_restored"]:
            self.log(f"fleet: recovered control plane under epoch "
                     f"{self.epoch}: {summary['recovered']} stream(s) "
                     f"re-admitted, {summary['terminal']} terminal "
                     f"session(s) retained"
                     + (", torn WAL tail dropped"
                        if summary["torn_tail"] else ""))
        obs.emit_event("router.recover", **{
            k: v for k, v in summary.items() if v is not None})
        return summary

    def handoff(self, successor: Optional[str] = None,
                retry_after: float = 0.5) -> Dict[str, Any]:
        """Lame-duck this router for a zero-downtime handoff: stop
        admitting (409 + successor hint), snapshot control state,
        flush and fence the WAL.  In-flight streams keep running and
        journaled attach/resume stays served; the successor claims
        the next epoch and replays what this router leaves behind."""
        self.router.enter_lame_duck(successor=successor,
                                    retry_after=retry_after)
        if self._state_store is not None:
            self._state_store.save(self.export_control_state())
        if self.wal is not None:
            self.wal.fence()
        self.log(f"fleet: handoff initiated (epoch {self.epoch}"
                 + (f", successor {successor}" if successor else "")
                 + "); WAL fenced, new admissions get 409")
        out = {"epoch": self.epoch, "successor": successor,
               "lame_duck": True}
        obs.emit_event("router.handoff", **out)
        return out

    def promote_standby(self,
                        timeout: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Turn a standby into the primary: claim the next epoch
        (fencing the old primary's WAL), replay its state + WAL, and
        open this fleet for admissions."""
        if not self.standby:
            raise RuntimeError("fleet is not a standby")
        self.standby = False
        self._init_durability()
        got = self.recover(timeout=timeout)
        if self._snap_thread is None and self._state_store is not None:
            self._snap_stop.clear()
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="fleet-state-snap",
                daemon=True)
            self._snap_thread.start()
        self.log(f"fleet: standby promoted to primary under epoch "
                 f"{self.epoch}")
        return got

    # -- constructors -------------------------------------------------------
    @classmethod
    def local(cls, net, spec: ServeSpec, size: int,
              workspace: Optional[str] = None, params=None,
              router_spec: Optional[RouterSpec] = None,
              rollout_spec: Optional[RolloutSpec] = None,
              tenancy: Optional[TenantRegistry] = None,
              warmup_modes=("generate", "predict"),
              standby: bool = False, log_fn=print,
              device=None) -> "EngineFleet":
        """Spawn `size` in-process engine workers (each its own
        pinned engine, batcher, and stats) over one shared net, on
        `device` (CUDA unless the caller passes device='cpu').  The
        ONE `tenancy` registry is shared by the router and every
        worker's admission path, so quotas agree at every hop."""
        if size < 1:
            raise ValueError(f"fleet size must be >= 1, got {size}")
        tenancy = tenancy if tenancy is not None else TenantRegistry()
        cfg = dict(net=net, spec=spec, workspace=workspace,
                   params=params, tenancy=tenancy,
                   warmup_modes=tuple(warmup_modes), device=device)
        handles = [_local_handle(cfg, f"engine-{i}", log_fn)
                   for i in range(size)]
        fleet = cls(handles, workspace=workspace,
                    router_spec=router_spec,
                    rollout_spec=rollout_spec, tenancy=tenancy,
                    standby=standby, log_fn=log_fn)
        fleet._spawn_cfg = cfg
        fleet._next_idx = size
        return fleet

    @classmethod
    def adopt(cls, urls: List[str], workspace: Optional[str] = None,
              router_spec: Optional[RouterSpec] = None,
              rollout_spec: Optional[RolloutSpec] = None,
              tenancy: Optional[TenantRegistry] = None,
              standby: bool = False, log_fn=print,
              transport: str = "auto") -> "EngineFleet":
        """Adopt already-running engine processes by base URL.

        `transport` picks the per-engine data plane: "auto" (default)
        negotiates per engine — the HTTP /healthz probe discovers a
        `wire_port` and upgrades that engine's requests/streams to
        the binary framed transport, degrading back to HTTP on any
        wire failure (serve/wire.py); "http" pins the debug surface
        unconditionally.  Mixed fleets are first-class: each engine
        negotiates independently, so routing, hedging, and failover
        cross the binary/HTTP boundary freely."""
        if transport not in ("auto", "http"):
            raise ValueError(f"transport must be auto|http, got "
                             f"{transport!r}")
        if transport == "auto":
            handles = [NegotiatingEngineHandle(f"engine-{i}", u,
                                               log_fn=log_fn)
                       for i, u in enumerate(urls)]
        else:
            handles = [HttpEngineHandle(f"engine-{i}", u)
                       for i, u in enumerate(urls)]
        return cls(handles, workspace=workspace,
                   router_spec=router_spec, rollout_spec=rollout_spec,
                   tenancy=tenancy, standby=standby, log_fn=log_fn)

    @classmethod
    def from_hostfile(cls, path: str, default_port: int = 8000,
                      **kw) -> "EngineFleet":
        """Adopt membership from a hostfile (one engine `host[:port]`
        per line — `parallel.bootstrap.parse_hostfile`, which rejects
        duplicates and empty membership)."""
        from ..parallel.bootstrap import parse_hostfile
        hosts = parse_hostfile(path)
        urls = [f"http://{h}" if ":" in h
                else f"http://{h}:{default_port}" for h in hosts]
        return cls.adopt(urls, **kw)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "EngineFleet":
        for h in self._local:
            h.start()
        self.router.start()
        # restore + replay BEFORE the rollout controller pins: a
        # restored pinned step must win over the members' cold-start
        # step, and recovered streams need engines adopted first
        if not self.standby:
            self.recover()
        if self.rollout is not None:
            # pin the fleet at the step the members actually serve —
            # unless recovery restored a promoted pin (restore_state
            # already set it; keep the max so a newer promotion that
            # members still serve is not walked back)
            steps = [self.router.engine_step(n)
                     for n in self.router.names()]
            pin = max(steps) if steps else -1
            self.rollout.start(max(pin, self.rollout.pinned_step))
        if not self.standby and self._state_store is not None and \
                self._snap_thread is None:
            self._snap_stop.clear()
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="fleet-state-snap",
                daemon=True)
            self._snap_thread.start()
        n_ok = len(self.router.healthy_names())
        self.log(f"fleet: {n_ok}/{len(self.router.names())} engine(s) "
                 f"healthy"
                 + (f", rollout pinned at step "
                    f"{self.rollout.pinned_step}"
                    if self.rollout is not None else "")
                 + (" [STANDBY: admissions closed until promote]"
                    if self.standby else ""))
        return self

    def stop(self) -> None:
        self._snap_stop.set()
        if self._snap_thread is not None:
            self._snap_thread.join(5.0)
            self._snap_thread = None
        if self.rollout is not None:
            self.rollout.stop()
        self.router.stop()
        if self.wal is not None:
            self.wal.close()
        for h in self._local:
            if h._alive:
                h.stop()
        # remote handles: drop pooled keep-alive sockets and any
        # persistent binary connections
        for name in self.router.names():
            h = self.router.handle_for(name)
            if h not in self._local and hasattr(h, "close"):
                try:
                    h.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def __enter__(self) -> "EngineFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- elastic membership (autoscaler surface) ----------------------------
    def can_grow(self) -> bool:
        return self._spawn_cfg is not None

    def grow(self) -> str:
        """Spawn, warm, and pin ONE new in-process worker, then hand
        it to the Router.  The ordering is the contract: load +
        warmup captures + reload-to-pinned-step all happen BEFORE
        `add_engine` — a cold engine must never eat live traffic.
        Returns the new engine's name."""
        cfg = self._spawn_cfg
        if cfg is None:
            raise RuntimeError("fleet cannot grow: not built with "
                               "EngineFleet.local()")
        with self._grow_lock:
            name = f"engine-{self._next_idx}"
            self._next_idx += 1
        h = _local_handle(cfg, name, self.log)
        eng = h.engine
        h.start()                  # load + warmup captures happen here
        pinned = (self.rollout.pinned_step
                  if self.rollout is not None else None)
        if pinned is not None and pinned >= 0 and \
                eng.params_step != pinned:
            got = h.reload(step=pinned)
            if int(got.get("step", -1)) != pinned:
                h.stop()
                raise RuntimeError(
                    f"new engine {name} could not reach pinned step "
                    f"{pinned} (landed {got.get('step')}); not joined")
        self._local.append(h)
        self.router.add_engine(h)
        return name

    def retire(self, name: str, drain: bool = True,
               timeout_s: float = 30.0) -> bool:
        """Drain and retire one worker through the Router's
        membership path; stop its server once drained.  On a drain
        timeout the handle is left running (still in `_local`) so
        in-flight streams can finish — `stop()` cleans it up."""
        drained = self.router.remove_engine(name, drain=drain,
                                            timeout_s=timeout_s)
        h = next((x for x in self._local if x.name == name), None)
        if h is not None and (drained or not drain):
            self._local.remove(h)
            if h._alive:
                h.stop()
        return drained

    # -- client API ---------------------------------------------------------
    def generate(self, tokens, timeout=None, deadline=None,
                 priority="interactive", tenant=None,
                 model=None) -> Dict[str, Any]:
        return self.router.route("generate", tokens, timeout=timeout,
                                 deadline=deadline, priority=priority,
                                 tenant=tenant, model=model)

    def generate_stream(self, tokens, timeout=None, max_new=None,
                        deadline=None, priority="interactive",
                        tenant=None, model=None):
        """Streaming generate through the fleet (cb members only):
        yields {"token": t} events then the {"done": True, ...}
        summary; retries on another engine only before the first
        event (Router.route_stream)."""
        return self.router.route_stream(tokens, timeout=timeout,
                                        max_new=max_new,
                                        deadline=deadline,
                                        priority=priority,
                                        tenant=tenant, model=model)

    def predict(self, tokens, timeout=None, deadline=None,
                priority="interactive", tenant=None,
                model=None) -> Dict[str, Any]:
        return self.router.route("predict", tokens, timeout=timeout,
                                 deadline=deadline, priority=priority,
                                 tenant=tenant, model=model)

    def snapshot(self) -> Dict[str, Any]:
        out = self.router.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.snapshot()
        out["standby"] = self.standby
        if self.wal is not None or self.standby:
            out["wal"] = self.wal_stats.snapshot()
        return out


def _local_handle(cfg: Dict[str, Any], name: str,
                  log_fn) -> LocalEngineHandle:
    """One in-process member from `EngineFleet.local`'s spawn config:
    a pinned engine on the config's device behind a listener-less
    server."""
    def log(s, n=name):
        log_fn(f"[{n}] {s}")
    eng = InferenceEngine(cfg["net"], cfg["spec"], cfg["params"],
                          device=cfg["device"],
                          workspace=cfg["workspace"], log_fn=log,
                          pinned=True)
    srv = InferenceServer(eng, http=False,
                          warmup_modes=cfg["warmup_modes"],
                          tenancy=cfg["tenancy"], log_fn=log)
    return LocalEngineHandle(name, srv)


# -- HTTP frontend ----------------------------------------------------------

class FleetServer:
    """The fleet's own stdlib-HTTP frontend (the single-engine
    `InferenceServer`'s shape, one level up): POST /generate and
    /predict route through the fleet; GET /stats, /metrics, /healthz
    read the router.  /healthz is honest at fleet level too: 200 while
    at least one engine is healthy, 503 when the whole fleet is."""

    def __init__(self, fleet: EngineFleet, host: str = "127.0.0.1",
                 port: int = 0, log_fn=print):
        from ..obs.metrics import MetricsRegistry
        from ..obs import perf
        self.fleet = fleet
        self.log = log_fn
        self.metrics = MetricsRegistry()
        self.fleet.router.stats.register_into(self.metrics)
        # performance observatory + process-level collector: the fleet
        # frontend exports the same compile/HBM/RSS surface as every
        # other /metrics endpoint
        perf.register_into(self.metrics)
        perf.register_process_into(self.metrics)
        # durable-stream session counters (singa_stream_*): failover /
        # splice / dedupe visibility next to the fleet counters
        self.fleet.router.sessions.stats.register_into(self.metrics)
        # control-plane durability (singa_router_wal_*): appends,
        # bytes, lost writes, fenced writes, replay/recovery counts
        self.fleet.wal_stats.register_into(self.metrics)
        # binary-transport counters + serialization-time split
        # (singa_wire_*): frames, malformed, fallbacks, ser/deser vs
        # json_ser/json_deser seconds — the transport A/B evidence
        wire.register_into(self.metrics)
        self._host, self._port = host, port
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None

    def start(self) -> "FleetServer":
        import json
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        import numpy as np

        from . import qos as _qos
        from .batcher import DeadlineExpired as _DE
        from .batcher import Overloaded as _OL
        from .router import UnknownModel as _UM

        fleet, metrics = self.fleet, self.metrics

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if fleet.epoch:
                    self.send_header(_qos.EPOCH_HEADER,
                                     str(fleet.epoch))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    self._reply(200, fleet.snapshot())
                elif self.path == "/trace":
                    # this process's span ring, Perfetto-shaped —
                    # obs.collect merges it with the workers' rings
                    self._reply(200, obs.trace_dump())
                elif self.path == "/debug/requests":
                    # per-request lifecycle records: last-N + slowest-N
                    # with stage attribution (router.RequestLog)
                    self._reply(200, fleet.router.requests.snapshot())
                elif self.path == "/metrics":
                    body = metrics.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/control/state":
                    # the durable control snapshot, live — what a
                    # successor (or an operator) would recover from
                    self._reply(200, fleet.export_control_state())
                elif self.path == "/healthz":
                    healthy = len(fleet.router.healthy_names())
                    total = len(fleet.router.names())
                    if fleet.standby:
                        # a standby is HEALTHY-but-not-serving: load
                        # balancers must not route to it, operators
                        # must see it alive and promotable
                        self._reply(200, {
                            "ok": True, "status": "standby",
                            "healthy_engines": healthy,
                            "engines": total})
                        return
                    ok = healthy > 0
                    status = "ok" if ok else "degraded"
                    if ok and fleet.router.lame_duck is not None:
                        status = "lame_duck"
                    self._reply(200 if ok else 503, {
                        "ok": ok,
                        "status": status,
                        "healthy_engines": healthy,
                        "engines": total})
                else:
                    self._reply(404,
                                {"error": f"no route {self.path}"})

            def _chunk(self, data):
                self.wfile.write(f"{len(data):X}\r\n".encode()
                                 + data + b"\r\n")

            def _remote_trace(self):
                """Client-supplied trace context (X-Trace-Id /
                X-Parent-Span), or None — malformed headers degrade
                to a fresh trace, never a 400 (qos.py)."""
                return _qos.trace_from_headers(
                    self.headers.get(_qos.TRACE_HEADER),
                    self.headers.get(_qos.PARENT_SPAN_HEADER))

            def _stream(self, req):
                """Chunked passthrough: re-serialize the engine's
                token events as they arrive — the full body is never
                buffered at the fleet tier.  route_stream raises
                BEFORE the 200 when no engine admits the stream, so
                admission errors keep their status codes; a
                mid-stream failure becomes a terminal {"error": ...}
                line.  A `session`/X-Session-Id reconnect ATTACHES to
                the journaled stream instead of admitting a new one —
                the restart/handoff resume path, deliberately served
                even while lame-ducked."""
                sid = req.get("session") or \
                    self.headers.get(_qos.SESSION_HEADER)
                if sid:
                    stream = fleet.router.attach_stream(
                        str(sid),
                        resume_from=int(req.get("resume_from", 0)))
                else:
                    tokens = np.asarray(req["tokens"], np.int32)
                    mn = req.get("max_new")
                    link = self._remote_trace()
                    # degrade-never-reject: garbled tenant folds to
                    # "default" (qos.check_tenant cannot raise)
                    tenant = _qos.check_tenant(
                        req.get("tenant")
                        or self.headers.get(_qos.TENANT_HEADER))
                    # the span covers ADMISSION only (route_stream
                    # admits eagerly and returns the generator) — the
                    # router's stream spans anchor to it via the
                    # thread-local; a span must never stay open across
                    # generator yields
                    with obs.span("fleet.request", mode="stream",
                                  tenant=tenant,
                                  trace=link[0] if link else None,
                                  parent=((link[1] or None)
                                          if link else None)):
                        stream = fleet.router.route_stream(
                            tokens, timeout=req.get("timeout"),
                            max_new=None if mn is None else int(mn),
                            deadline=_qos.deadline_from_header(
                                self.headers.get(
                                    _qos.DEADLINE_HEADER)),
                            priority=_qos.check_priority(
                                req.get("priority")
                                or self.headers.get(
                                    _qos.PRIORITY_HEADER)),
                            tenant=tenant, model=req.get("model"))
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                if fleet.epoch:
                    self.send_header(_qos.EPOCH_HEADER,
                                     str(fleet.epoch))
                self.end_headers()
                # batched token flushes (serve/wire.py): several
                # ndjson lines per chunked write under the router
                # spec's flush knobs.  The coalescer flushes the
                # first line of the stream immediately — first-token
                # latency is a gated stage
                co = wire.LineCoalescer(
                    self._chunk,
                    flush_tokens=fleet.router.spec.flush_tokens,
                    flush_ms=fleet.router.spec.flush_ms)
                try:
                    for ev in stream:
                        co.add(wire.timed_json_dumps(ev) + b"\n",
                               urgent=bool(ev.get("done")))
                except Exception as e:  # noqa: BLE001 — mid-stream
                    co.add(json.dumps(
                        {"error":
                         f"{type(e).__name__}: {e}"}).encode()
                        + b"\n", urgent=True)
                co.flush()
                self._chunk(b"")

            def do_POST(self):
                if self.path == "/admin/handoff":
                    self._admin_handoff()
                    return
                if self.path == "/admin/promote":
                    self._admin_promote()
                    return
                mode = self.path.lstrip("/")
                if mode not in ("generate", "predict"):
                    self._reply(404,
                                {"error": f"no route {self.path}"})
                    return
                if fleet.standby:
                    # the standby's data plane is closed until it is
                    # promoted: routing here would split-brain the
                    # session journal across two unfenced writers
                    self._reply(503, {
                        "error": "standby router: promote before "
                                 "sending traffic",
                        "status": "standby"},
                        {"Retry-After": "1.0"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if mode == "generate" and req.get("stream"):
                        self._stream(req)
                        return
                    tokens = np.asarray(req["tokens"], np.int32)
                    link = self._remote_trace()
                    tenant = _qos.check_tenant(
                        req.get("tenant")
                        or self.headers.get(_qos.TENANT_HEADER))
                    with obs.span("fleet.request", mode=mode,
                                  tenant=tenant,
                                  trace=link[0] if link else None,
                                  parent=((link[1] or None)
                                          if link else None)):
                        out = fleet.router.route(
                            mode, tokens,
                            timeout=req.get("timeout"),
                            deadline=_qos.deadline_from_header(
                                self.headers.get(
                                    _qos.DEADLINE_HEADER)),
                            priority=_qos.check_priority(
                                req.get("priority")
                                or self.headers.get(
                                    _qos.PRIORITY_HEADER)),
                            tenant=tenant, model=req.get("model"))
                    self._reply(200, out)
                except _UM as e:
                    # honest fast 404: the fleet does not serve this
                    # model family — never a shed, never a strike
                    self._reply(404, {"error": str(e)})
                except LameDuck as e:
                    # handing off: 409 points the client at the
                    # successor — before KeyError/RuntimeError arms
                    # (LameDuck IS a RuntimeError)
                    self._reply(409, {"error": str(e),
                                      "successor": e.successor,
                                      "retry_after": e.retry_after},
                                {"Retry-After":
                                 f"{e.retry_after:.3f}"})
                except UnknownSession as e:
                    # 410 Gone, not 404: the sid grammar was right but
                    # the journaled session is finished-and-evicted or
                    # never existed — retrying cannot help
                    self._reply(410, {"error": str(e)})
                except _OL as e:
                    self._reply(503, {"error": str(e),
                                      "retry_after": e.retry_after},
                                {"Retry-After":
                                 f"{e.retry_after:.3f}"})
                except (_DE, TimeoutError) as e:
                    self._reply(504, {"error": str(e)})
                except (KeyError, ValueError,
                        json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error":
                                      f"{type(e).__name__}: {e}"})

            def _admin_handoff(self):
                """Lame-duck this router for a zero-downtime handoff
                (EngineFleet.handoff): body {"successor": url?,
                "retry_after": s?}."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = fleet.handoff(
                        successor=req.get("successor"),
                        retry_after=float(req.get("retry_after",
                                                  0.5)))
                    self._reply(200, out)
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error":
                                      f"{type(e).__name__}: {e}"})

            def _admin_promote(self):
                """Promote a standby to primary: claim the next
                epoch (fencing the old primary) and replay its WAL."""
                try:
                    got = fleet.promote_standby()
                    self._reply(200, got)
                except RuntimeError as e:
                    # not a standby: promoting a live primary would
                    # fence ITS OWN WAL out from under it
                    self._reply(409, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error":
                                      f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-http",
            daemon=True)
        self._http_thread.start()
        self.log(f"fleet: http on {self.address[0]}:"
                 f"{self.address[1]}")
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None

    @property
    def address(self):
        return self._httpd.server_address if self._httpd else None
