"""Deterministic fault injection for the training runtime.

The port's own copy of `singa_tpu/utils/faults.py`, which is JAX-free
(the port imports nothing of the JAX package).  Its serving sites
(`engine.stall`, `serve.admit`, `serve.batch`) are instrumented in the
port; the training sites come with the port of the supervisor.

The reference designed failure recovery but never shipped it
(Worker::Resume is an empty TODO, worker.cc:65-67) — partly because a
recovery path you cannot trigger on demand is a recovery path you never
test.  This module makes every failure mode reproducible on CPU: a
seeded `FaultSchedule` fires exceptions (or simulated preemptions, or
silent data corruption) at named *sites* instrumented throughout the
runtime, so tests and `scripts/fault_smoke.sh` can kill a run at step k,
tear a checkpoint, or corrupt one record and assert the supervisor
recovers to the exact uninterrupted trajectory.

Sites (each `maybe_fault(site)` call is one *visit*; visits are counted
per site across the whole process, including replayed steps after a
restart — so a one-shot fault never re-fires during recovery):

    data.decode    one record decoded (Prefetcher producer / shard read)
    data.prefetch  one batch handed to the consumer (Prefetcher.__next__)
    feed.stage     one chunk staged (ChunkStager.stage: stack +
                   device_put — fires on the DeviceFeeder producer
                   thread in the overlapped loop, inline otherwise)
    ckpt.save      one checkpoint save (before finalize)
    ckpt.restore   one checkpoint restore attempt
    sync.elastic   one cross-slice center exchange (elastic/randomsync)
    sync.delta     one replica contribution handed to a center exchange
                   (ElasticController.maybe_sync /
                   DistributedReplicaSet._sync — the silent kinds
                   poison the delta so validation/quarantine paths are
                   testable)
    step.train     one training-loop iteration (Trainer.run / run_cd)
    step.grad      one training step's gradients (Trainer.run consults
                   per step; the silent kinds poison the compiled
                   step's grads so numeric-health detection is
                   testable on CPU)
    serve.admit    one request admitted to the serving queue
                   (MicroBatcher.submit — an error sheds the request
                   with a Backoff retry hint instead of crashing)
    serve.batch    one micro-batch dispatched to the inference engine
                   (MicroBatcher dispatch loop — an error fails that
                   batch's requests; the server stays up)
    serve.reload   one checkpoint hot-reload attempt
                   (InferenceEngine.poll_reload / reload_to — an error
                   degrades to keep-serving-old-params, counted in
                   ServeStats; on a fleet canary it turns the rollout
                   into a counted refusal)
    fleet.dispatch one routed request attempt (Router.route — an error
                   is charged to the chosen engine exactly like a real
                   engine failure: the request retries on another
                   engine and the engine earns a strike)
    serve.hedge    one hedged dispatch fired (Router — an error abandons
                   that hedge attempt only: the primary dispatch is
                   untouched and the request's outcome is whatever the
                   primary returns, so a broken hedge path can never
                   make tail latency worse than no hedging)
    engine.stall   one compiled-program invocation (run_batch /
                   run_cb_prefill / run_cb_decode).  The silent "stall"
                   kind latches `ServeSpec.stall_fault_s` of host-side
                   sleep onto THAT engine's every subsequent program
                   call — the deterministic slow-replica lever the
                   hedging bench uses to prove a straggler cannot own
                   p99.  An "error" kind fails that one call (the
                   batch/step failure story above)
    fleet.rollout  one rollout-controller tick (RolloutController —
                   an error mid-canary aborts the rollout safely:
                   the canary is rolled back to the pinned step and
                   the fleet never promotes)
    pipeline.publish
                   one checkpoint publication in the closed train-and-
                   serve loop (PipelineController._on_publish — an
                   error degrades to a counted `publish_faults`: the
                   blessed step is still recorded and the rollout
                   controller still notices the fingerprint change on
                   its own poll, so a lost publish notification never
                   loses a promotion)
    scale.decide   one autoscaler control tick (AutoScaler.tick — an
                   error skips that tick's decision, counted in
                   `decide_faults` and evented `scale.abort`; a
                   faulted tick never spawns and NEVER retires an
                   engine, so fault injection can't shrink a fleet)
    obs.emit       one telemetry record written (a span recorded, an
                   event-log line appended, a trace exported — every
                   obs write path swallows the fault into a drop
                   counter, proving telemetry failure never takes
                   down training or serving)
    obs.flush      the observability session teardown (trace export,
                   final metrics dump, event-log close — a faulted
                   flush is itself a flight-recorder trigger:
                   `flightrec-obs_flush_fault-*.json` preserves the
                   window the lost export would have covered)
    serve.resume   one mid-stream failover resume attempt
                   (Router._failover_leg — an error abandons the
                   resume and the stream degrades to the pre-failover
                   terminal error: the client sees exactly the old
                   mid-stream RuntimeError, never a hang and never a
                   duplicated token)
    wire.frame     one outbound binary-transport frame (serve/wire.py
                   send path — an "error" kind DROPS the frame and
                   fails the connection, a "corrupt" kind flips bytes
                   so the receiver counts `wire_malformed_total` and
                   closes, a silent "torn" kind writes half the frame
                   then fails the sender.  All three degrade to a
                   counted reconnect or a per-request failure the
                   Router's retry/failover machinery absorbs — never
                   a hang, never an undetected bad payload)

Fault kinds:

    error    raise FaultError (a generic failure at the site)
    preempt  raise Preemption (the job is killed; a Supervisor treats it
             exactly like a SIGTERM'd process that restarts)
    corrupt  raise CorruptRecord (data sites: the record is bad; the
             pipeline quarantines it and continues)
    torn     no exception — maybe_fault returns "torn" and the SITE
             decides how to honor it (ckpt.save writes a truncated
             snapshot: a save that "succeeded" but left garbage on disk)
    nan      no exception — the site poisons the value with NaNs (a
             silent numeric failure: grads at step.grad, the exchanged
             delta at sync.delta) and training continues until the
             health tier notices
    spike    no exception — the site scales the value by a large factor
             (an exploding-gradient / corrupted-delta event that stays
             finite)
    stall    no exception — the site latches an injected latency onto
             itself (engine.stall: every later compiled call on that
             engine sleeps `stall_fault_s`; the slow replica that drags
             fleet p99 without ever failing a health probe)

Instrumented code calls `maybe_fault(site)` — a no-op returning None
unless a schedule is active via `inject(schedule)`.  Overhead when
inactive is one global read.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SITES = ("data.decode", "data.prefetch", "feed.stage", "ckpt.save",
         "ckpt.restore", "sync.elastic", "sync.delta", "step.train",
         "step.grad", "serve.admit", "serve.batch", "serve.reload",
         "serve.hedge", "engine.stall", "fleet.dispatch",
         "fleet.rollout", "pipeline.publish", "scale.decide",
         "obs.emit", "serve.resume", "obs.flush", "router.wal",
         "router.recover", "wire.frame")

KINDS = ("error", "preempt", "corrupt", "torn", "nan", "spike",
         "stall")

#: kinds that do not raise: maybe_fault returns the kind string and the
#: instrumented SITE decides how to honor it (tear a snapshot, poison a
#: gradient or sync delta, latch a latency stall)
SILENT_KINDS = ("torn", "nan", "spike", "stall")


class FaultError(RuntimeError):
    """A generic injected failure at a site."""


class Preemption(FaultError):
    """A simulated preemption: the run is killed at this point.  The
    Supervisor treats it like any crash — restore + replay — but keeps
    it distinct in the failure log (preemptions are expected on
    preemptible TPU slices; repeated *errors* are a bug)."""


class CorruptRecord(FaultError):
    """An injected bad data record; the pipeline quarantines it (skips
    and counts) instead of failing the run."""


_KIND_EXC = {"error": FaultError, "preempt": Preemption,
             "corrupt": CorruptRecord}


@dataclass
class FaultSpec:
    """Fire `kind` at the `at`-th visit (0-based) of `site`, once."""
    site: str
    at: int
    kind: str = "error"
    fired: bool = False

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds are {KINDS}")


@dataclass
class FiredFault:
    site: str
    visit: int
    kind: str
    time: float


class FaultSchedule:
    """Deterministic per-site fault plan: one-shot `FaultSpec`s plus
    optional seeded per-visit probabilities (`rates`, site -> p) for
    chaos runs.  Thread-safe — the prefetch producer thread and the
    training loop consult the same schedule."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None,
                 rates: Optional[Dict[str, float]] = None,
                 rate_kind: str = "error", seed: int = 0):
        import numpy as np
        self.specs = list(specs or [])
        self.rates = dict(rates or {})
        for site in self.rates:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}")
        if rate_kind not in KINDS:
            raise ValueError(f"unknown fault kind {rate_kind!r}")
        self.rate_kind = rate_kind
        self._rng = np.random.default_rng(seed)
        self._visits: Dict[str, int] = {}
        self.fired: List[FiredFault] = []
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        """Parse a CLI spec: comma/semicolon-separated `site@visit:kind`
        entries, e.g. `"step.train@7:preempt,ckpt.save@1:torn"`.  The
        kind defaults to `error`."""
        specs = []
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                site, rest = part.split("@", 1)
                at, _, kind = rest.partition(":")
                specs.append(FaultSpec(site=site.strip(), at=int(at),
                                       kind=(kind.strip() or "error")))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec entry {part!r} (want "
                    f"site@visit[:kind]): {e}") from e
        return cls(specs, seed=seed)

    def visits(self, site: str) -> int:
        with self._lock:
            return self._visits.get(site, 0)

    def visit(self, site: str) -> Optional[str]:
        """Record one visit to `site`; raise / return the scheduled
        fault if any.  Returns the kind string for the non-raising
        (silent) kinds — "torn", "nan", "spike" — None otherwise."""
        with self._lock:
            n = self._visits.get(site, 0)
            self._visits[site] = n + 1
            kind = None
            for s in self.specs:
                if s.site == site and s.at == n and not s.fired:
                    s.fired = True
                    kind = s.kind
                    break
            if kind is None and site in self.rates:
                if self._rng.random() < self.rates[site]:
                    kind = self.rate_kind
            if kind is None:
                return None
            self.fired.append(FiredFault(site, n, kind, time.time()))
        if kind in SILENT_KINDS:
            return kind
        raise _KIND_EXC[kind](f"injected {kind} at {site} (visit {n})")


# -- process-wide activation ----------------------------------------------
_ACTIVE: Optional[FaultSchedule] = None


def active() -> Optional[FaultSchedule]:
    return _ACTIVE


def maybe_fault(site: str) -> Optional[str]:
    """Consult the active schedule at an instrumented site.  No-op
    (None) when no schedule is installed."""
    sch = _ACTIVE
    return sch.visit(site) if sch is not None else None


@contextmanager
def inject(schedule: Optional[FaultSchedule]):
    """Activate `schedule` for the dynamic extent of the block.  Nesting
    replaces (and restores) the outer schedule; None is a no-op."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = schedule
    try:
        yield schedule
    finally:
        _ACTIVE = prev


# -- retry/backoff ---------------------------------------------------------
@dataclass
class Backoff:
    """Exponential backoff with seeded jitter — deterministic delays in
    tests, decorrelated retries in a fleet (every worker hashing its
    coordinates into `seed` avoids a retry stampede after a shared
    outage).  delay(k) = min(cap, base * 2^k) * (1 + jitter*u),
    u ~ U[0,1) from the seeded stream."""
    base: float = 0.5
    cap: float = 30.0
    jitter: float = 0.25
    seed: int = 0
    _rng: object = field(default=None, repr=False)

    def delay(self, attempt: int) -> float:
        import numpy as np
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        d = min(self.cap, self.base * (2.0 ** max(attempt, 0)))
        return d * (1.0 + self.jitter * float(self._rng.random()))

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)
        return d


def retry_call(fn, attempts: int, backoff: Backoff, log=None,
               what: str = "operation"):
    """Run `fn()` with up to `attempts` total tries, sleeping the
    backoff between failures.  Preemptions are never retried here — they
    mean the whole process is going away, so they propagate to the
    supervisor immediately.  Returns fn()'s value, or raises the last
    failure after the budget is spent."""
    last: Optional[BaseException] = None
    for k in range(max(attempts, 1)):
        try:
            return fn()
        except Preemption:
            raise
        except Exception as e:  # noqa: BLE001 — retry any site failure
            last = e
            if log is not None:
                log(f"warning: {what} failed (attempt {k + 1}/"
                    f"{attempts}): {e}")
            if k + 1 < attempts:
                backoff.sleep(k)
    raise last
