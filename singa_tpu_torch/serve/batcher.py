"""Deadline-aware micro-batcher: coalesce queued requests into the
smallest admissible bucket program.

Port of `singa_tpu/serve/batcher.py` (`Ticket`, `MicroBatcher` and the
three admission exceptions, which `ContinuousScheduler` raises too).
The bucket programs are the engine's CUDA graphs on the card; the
dispatch thread only replays them (`InferenceServer.start()` captures
them on the caller's thread first).

Admission (`submit`) is bounded-queue with `Backoff`-based shedding:
a full queue (or an injected `serve.admit` fault) raises `Overloaded`
carrying a `retry_after` hint that grows exponentially with
consecutive sheds — callers that honor it decongest the queue instead
of hammering it.  Admitted requests get a `Ticket` (a tiny future);
`Ticket.wait()` returns the result dict or raises the failure.

The dispatch loop gathers the queue head, waits at most
`batch_window_s` for co-batchable arrivals (early-out when the widest
bucket fills), drops requests whose deadline passed while queued
(counted `expired`, failed with `DeadlineExpired`), picks
`spec.bucket_for(n, max_plen)` and LEFT-pads every prompt to the
bucket length (`plens` carries the real lengths for the engine's
kmask).  Overflow beyond the bucket's batch goes back to the queue
head.  Pad rows are dummy single-pad-token prompts — they decode
garbage nobody reads; occupancy (real/slots) is the stat that prices
them.

Fault sites: `serve.admit` (shed one request), `serve.batch` (fail
one dispatched batch's requests — the loop and the server stay up).
Params atomicity: each batch runs inside `engine.hold()`, which holds
the engine's lock from the params read to the fetched result; a hot
reload copies into the live params under the same lock, so it cannot
tear a batch (see engine.py).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils import faults
from . import qos
from .engine import InferenceEngine
from .stats import ServeStats
from .tenancy import TenantRegistry


class Overloaded(RuntimeError):
    """Admission rejected; retry after `retry_after` seconds."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it was dispatched.  With
    end-to-end propagation (serve/qos.py) this includes dead on
    arrival: the remaining budget was already <= 0 at admission."""


class Cancelled(RuntimeError):
    """The caller cancelled the request (a hedge's losing attempt):
    dropped from the queue / retired from its slot, counted
    `cancelled` — never `failed`, never a strike."""


class Ticket:
    """One request's future: wait() blocks until the dispatch loop
    resolves or fails it."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, result: Dict[str, Any]) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._done.wait(timeout):
            raise TimeoutError("request still queued/running")
        if self._error is not None:
            raise self._error
        return self._result


@dataclass
class _Request:
    tokens: np.ndarray            # (plen,) int32
    plen: int
    mode: str
    ticket: Ticket
    t_submit: float
    deadline: Optional[float]     # monotonic, None = no deadline
    priority: str = "interactive"
    tenant: str = "default"       # registry-folded tenant label
    cancel_event: Optional[threading.Event] = None
    extra: Dict[str, Any] = field(default_factory=dict)


class MicroBatcher:
    """See module docstring.  One daemon dispatch thread; `submit` is
    called from any number of frontend threads."""

    def __init__(self, engine: InferenceEngine,
                 stats: Optional[ServeStats] = None, log_fn=print,
                 backoff: Optional[faults.Backoff] = None,
                 tenancy: Optional[TenantRegistry] = None):
        self.engine = engine
        self.spec = engine.spec
        self.stats = stats if stats is not None else engine.stats
        self.log = log_fn
        # per-tenant queue quotas + brownout overrides (an
        # unconfigured registry is all-default: no quota, engine
        # fractions — exact legacy admission)
        self.tenancy = tenancy or TenantRegistry()
        self._backoff = backoff if backoff is not None else \
            faults.Backoff(base=0.05, cap=2.0, seed=self.spec.seed)
        self._q: deque = deque()
        self._cv = threading.Condition()
        # correlation ids: req-N assigned at admission, batch-M at
        # dispatch; the dispatch span lists its requests' corrs, and
        # engine spans open inside it — request→batch→engine is one
        # traceable flow (docs/OBSERVABILITY.md)
        self._req_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        # per-class shed streaks/backoffs (honest per-class
        # Retry-After; the interactive stream matches the old
        # single-class behavior bit-for-bit)
        self._class_backoffs = qos.ClassBackoffs(
            base=getattr(self._backoff, "base", 0.05),
            cap=getattr(self._backoff, "cap", 2.0),
            seed=getattr(self._backoff, "seed", self.spec.seed))
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # fail anything still queued so no client blocks forever
        with self._cv:
            leftovers = list(self._q)
            self._q.clear()
            self.stats.gauge("queue_depth", 0)
        for r in leftovers:
            self.stats.count("failed")
            r.ticket._fail(RuntimeError("server shutting down"))

    # -- admission ----------------------------------------------------------
    def submit(self, tokens, mode: str = "generate",
               timeout: Optional[float] = None,
               deadline: Optional[float] = None,
               priority: str = "interactive",
               cancel_event: Optional[threading.Event] = None,
               tenant: Optional[str] = None) -> Ticket:
        """Admit one request.  `tokens` is a 1-D int32 prompt;
        `deadline` (absolute monotonic; wins over `timeout`, which
        still derives one: spec.request_timeout_s default, <=0 = none)
        bounds time-in-queue — a request dead on arrival is refused
        before it queues (`expired_on_arrival`).  `priority`
        (serve/qos.py classes) drives brownout: under queue pressure
        lower classes shed first with an honest per-class Retry-After.
        `tenant` (folded through the registry; None = `default`)
        enforces the tenant's queue quota and scopes its Retry-After
        streak — one tenant filling its quota sheds ITS overflow, not
        a neighbor's traffic.  `cancel_event`, when set by the caller,
        drops the request at the next gather (counted `cancelled`).
        Raises `Overloaded` (with `retry_after`) on shed; ValueError
        for an unservable prompt or unknown priority."""
        arr = np.asarray(tokens, np.int32).reshape(-1)
        if arr.size < 1:
            self.stats.count("rejected")
            raise ValueError("empty prompt")
        if arr.size > self.spec.max_prompt_len:
            # fail fast at admission (the HTTP layer's 400): an
            # unservable prompt must not sit in the queue until its
            # deadline turns it into a 504
            self.stats.count("rejected")
            raise ValueError(
                f"prompt length {arr.size} exceeds the largest bucket "
                f"({self.spec.max_prompt_len}); not servable")
        if mode not in ("generate", "predict"):
            self.stats.count("rejected")
            raise ValueError(f"unknown mode {mode!r}")
        try:
            priority = qos.check_priority(priority)
        except ValueError:
            self.stats.count("rejected")
            raise
        tenant = self.tenancy.label(tenant)
        deadline = qos.resolve_deadline(timeout, deadline,
                                        self.spec.request_timeout_s)
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            # dead on arrival: refuse before it queues — zero queue
            # time, zero engine work burned on a client that gave up
            self.stats.count("expired_on_arrival")
            raise DeadlineExpired(
                f"dead on arrival: deadline passed "
                f"{now - deadline:.3f}s before admission")
        corr = f"req-{next(self._req_ids)}"
        req = _Request(tokens=arr, plen=int(arr.size), mode=mode,
                       ticket=Ticket(), t_submit=now,
                       deadline=deadline, priority=priority,
                       tenant=tenant, cancel_event=cancel_event,
                       extra={"corr": corr})
        with obs.span("batcher.admit", corr=corr, mode=mode,
                      plen=int(arr.size), priority=priority,
                      tenant=tenant):
            try:
                faults.maybe_fault("serve.admit")
            except faults.FaultError as e:
                return self._shed(f"admission fault: {e}", corr=corr,
                                  priority=priority, tenant=tenant)
            quota = self.tenancy.queue_quota(
                tenant, self.spec.queue_capacity)
            with self._cv:
                if self._stop:
                    raise RuntimeError("batcher is stopped")
                depth = len(self._q)
                tdepth = sum(1 for r in self._q if r.tenant == tenant)
                if depth >= self.spec.queue_capacity or \
                        tdepth >= quota or \
                        not self._brownout_admits(priority, depth,
                                                  tenant):
                    pass  # shed outside the lock's happy path below
                else:
                    self._q.append(req)
                    self._class_backoffs.reset(priority, tenant=tenant)
                    self.stats.count("submitted")
                    self.stats.tenants.count("submitted", tenant)
                    self.stats.gauge("queue_depth", len(self._q))
                    self._cv.notify()
                    return req.ticket
            if depth >= self.spec.queue_capacity:
                why = f"queue full ({self.spec.queue_capacity} requests)"
            elif tdepth >= quota:
                why = (f"tenant {tenant} queue quota full "
                       f"({tdepth}/{quota} of "
                       f"{self.spec.queue_capacity})")
            else:
                why = (f"brownout: queue {depth}/"
                       f"{self.spec.queue_capacity} sheds {priority}")
            return self._shed(why, corr=corr, priority=priority,
                              tenant=tenant)

    def _brownout_admits(self, priority: str, depth: int,
                         tenant: str = "default") -> bool:
        """Class-aware admission under pressure: best_effort is shed
        once the queue is `brownout_be_frac` full, batch at
        `brownout_batch_frac`; interactive rides to the cap.  A tenant
        with configured brownout overrides uses its own fractions."""
        if priority == "interactive":
            return True
        be_frac, batch_frac = self.tenancy.brownout_fracs(
            tenant, self.spec.brownout_be_frac,
            self.spec.brownout_batch_frac)
        frac = be_frac if priority == "best_effort" else batch_frac
        return depth < max(int(frac * self.spec.queue_capacity), 1)

    def _shed(self, why: str, corr: Optional[str] = None,
              priority: str = "interactive",
              tenant: str = "default") -> "Ticket":
        self.stats.count("shed")
        self.stats.count(f"shed_{priority}")
        self.stats.tenants.count("shed", tenant)
        retry = self._class_backoffs.shed_delay(priority,
                                                tenant=tenant)
        obs.emit_event("serve.shed", why=why, corr=corr,
                       priority=priority, tenant=tenant,
                       retry_after=round(retry, 4))
        raise Overloaded(f"request shed ({why}); retry after "
                         f"{retry:.3f}s", retry_after=retry)

    # -- dispatch loop ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            gathered = self._gather()
            if gathered is None:
                if self._stop:
                    return
                continue
            reqs, bucket = gathered
            self._dispatch(reqs, bucket)

    def _gather(self) -> Optional[Tuple[List[_Request],
                                        Tuple[int, int]]]:
        """Block for work, coalesce within the batch window, expire
        stale requests, choose a bucket, and push overflow back."""
        spec = self.spec
        with self._cv:
            while not self._q and not self._stop:
                self._cv.wait(0.1)
            if not self._q:
                return None
            t_end = time.monotonic() + spec.batch_window_s
            while len(self._q) < spec.max_batch and not self._stop:
                rem = t_end - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(rem)
            # take same-mode requests from the head; different-mode
            # ones go back to the head (they lead the next gather)
            mode = self._q[0].mode
            reqs: List[_Request] = []
            defer: List[_Request] = []
            now = time.monotonic()
            while self._q and len(reqs) < spec.max_batch:
                r = self._q.popleft()
                if r.cancel_event is not None and \
                        r.cancel_event.is_set():
                    # hedge loser: dropped before any engine work
                    self.stats.count("cancelled")
                    r.ticket._fail(Cancelled(
                        "cancelled by caller while queued"))
                    continue
                if r.deadline is not None and now > r.deadline:
                    self.stats.count("expired")
                    r.ticket._fail(DeadlineExpired(
                        f"deadline passed after "
                        f"{now - r.t_submit:.3f}s in queue"))
                    continue
                if r.mode != mode:
                    defer.append(r)
                    continue
                reqs.append(r)
            if not reqs:
                self._q.extendleft(reversed(defer))
                self.stats.gauge("queue_depth", len(self._q))
                return None
            bucket = spec.bucket_for(len(reqs),
                                     max(r.plen for r in reqs))
            if len(reqs) > bucket[0]:
                defer = reqs[bucket[0]:] + defer
                reqs = reqs[:bucket[0]]
            self._q.extendleft(reversed(defer))
            self.stats.gauge("queue_depth", len(self._q))
        return reqs, bucket

    def _dispatch(self, reqs: List[_Request],
                  bucket: Tuple[int, int]) -> None:
        b, p = bucket
        corr = f"batch-{next(self._batch_ids)}"
        with obs.span("batcher.dispatch", corr=corr, batch=b, plen=p,
                      reqs=[r.extra.get("corr") for r in reqs]):
            self._dispatch_batch(reqs, bucket)

    def _dispatch_batch(self, reqs: List[_Request],
                        bucket: Tuple[int, int]) -> None:
        b, p = bucket
        t_disp = time.monotonic()
        try:
            faults.maybe_fault("serve.batch")
            tokens = np.full((b, p), self.spec.pad_id, np.int32)
            plens = np.ones((b,), np.int32)   # pad rows: 1-token dummy
            for i, r in enumerate(reqs):
                tokens[i, p - r.plen:] = r.tokens
                plens[i] = r.plen
            mode = reqs[0].mode
            # ONE hold of the live params: a concurrent hot reload
            # cannot copy into them under this batch
            with self.engine.hold() as (params, step):
                out = self.engine.run_batch(mode, tokens, plens,
                                            params=params)
        except Exception as e:  # noqa: BLE001 — fail batch, keep serving
            self.stats.count("failed", len(reqs))
            # one more strike toward the degraded /healthz verdict
            # (reset by observe_batch on the next successful dispatch)
            self.stats.observe_batch_failure()
            self.log(f"warning: serve batch failed "
                     f"({type(e).__name__}: {e}); {len(reqs)} "
                     f"request(s) failed, server continues")
            for r in reqs:
                r.ticket._fail(e if isinstance(e, faults.FaultError)
                               else RuntimeError(f"batch failed: {e}"))
            return
        self.stats.observe_batch(len(reqs), b)
        now = time.monotonic()
        for i, r in enumerate(reqs):
            if r.mode == "generate":
                toks = self._trim_eos(out[i])
                result = {"tokens": toks, "step": step,
                          "bucket": [b, p]}
                ntok = len(toks)
            else:
                result = {"logprobs": out[i].tolist(), "step": step,
                          "bucket": [b, p]}
                ntok = 0
            self.stats.observe_latency(now - r.t_submit)
            self.stats.tenants.count("completed", r.tenant)
            self.stats.tenants.observe_latency(now - r.t_submit,
                                               r.tenant)
            # queue-wait = submit -> this dispatch; service = the
            # batch's device time (shared across its requests)
            self.stats.observe_request(t_disp - r.t_submit,
                                       now - t_disp, ntok)
            r.ticket._resolve(result)

    def _trim_eos(self, row: np.ndarray) -> List[int]:
        eos = self.spec.eos_id
        toks = row.tolist()
        if eos is None or eos not in toks:
            return toks
        return toks[:toks.index(eos) + 1]
