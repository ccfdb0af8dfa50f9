"""Continuous-batching scheduler: per-slot admission into a running
decode batch over the paged KV cache.

Port of `singa_tpu/serve/scheduler.py:69-704`.  The engine's two
programs are CUDA graphs on the card: `start()` captures them on the
caller's thread (`engine.warmup`) before the loop thread starts, since a
capture fails while another thread works on the card; the loop thread
only replays.  Its telemetry is the reference's: the `scheduler.admit`
and `scheduler.prefill` spans, the `serve.shed` and `serve.cb_retire`
events, and the `kv_pool` MemoryWatch component.

The static MicroBatcher ties a request's fate to its batch: the
bucket program decodes all `max_new_tokens` for every row, so one long
generation holds every co-batched short request hostage (the
head-of-line gap between p50 and p95 latency).  Here a request
occupies one of `cb_slots` SLOTS instead:

  admit    a free slot at ANY decode step — reserve its worst-case
           blocks (ceil((plen + max_new) / block_len), so pool
           exhaustion is an admission decision, never a mid-decode
           OOM), run the ONE prefill program into them, and
           join the running batch on the next step;
  step     the ONE fixed-slot-count decode program advances
           every active slot a token; inactive slots ride along
           pointing at the null block (garbage out, masked, ignored);
  retire   on EOS / max-new / deadline the slot's blocks return to
           the free pool immediately and the slot is free for the
           next admission that very step.

Control plane vs data plane ("RPC Considered Harmful"): everything in
this file is host-side numpy bookkeeping; device work is exactly one
program replay per prefill and one per decode step, both captured at
warmup with (slots, blocks-per-slot, block_len, pool size) as the only
geometry — no capture after warmup, same guarantee as the bucket path.

Params atomicity: each iteration runs inside `engine.hold()`, which
holds the engine's lock across that iteration's prefills and decode
step; a hot reload copies into the live params under the same lock, so
it can never tear a step.  A stream that spans a
reload finishes on the new params from the next step on — each step
is internally consistent, which is the no-tear guarantee the static
path makes per batch.

Admission is strict FIFO: when the queue head cannot get a slot or
its blocks, nothing behind it jumps ahead (no starvation of long
prompts).  Shedding (`Overloaded` + Backoff retry_after) happens only
when the pending queue itself is full — the same story as the
MicroBatcher, with the block pool as the second bounded resource.

Fault sites: `serve.admit` (shed one submission), `serve.batch` (fail
one decode step — its active requests fail, the loop and server stay
up, `consecutive_batch_failures` moves toward the degraded verdict).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import obs
from ..obs import perf
from ..device import params_dtype
from ..utils import faults
from . import qos
from .batcher import Cancelled, DeadlineExpired, Overloaded
from .engine import InferenceEngine
from .kvcache import PagedKVCache, pool_bytes
from .stats import ServeStats
from .tenancy import TenantRegistry


class StreamTicket:
    """One request's future, streaming edition: tokens are observable
    as they are produced (`events()` / `tokens()`), and `wait()`
    blocks for the final result dict exactly like `Ticket.wait`."""

    def __init__(self, corr: Optional[str] = None,
                 first_index: int = 0):
        self.corr = corr
        # absolute sequence number of the FIRST token this ticket will
        # emit: 0 for a fresh stream, `resume_from` for a failover
        # re-admission — the k-th emitted token is index
        # first_index + k, so both legs of a spliced stream number
        # consistently and the router can dedupe by index
        self.first_index = int(first_index)
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    # -- producer side (scheduler thread) -----------------------------------
    def _emit(self, token: int) -> None:
        self._q.put(("tok", int(token)))

    def _resolve(self, result: Dict[str, Any]) -> None:
        self._result = result
        self._done.set()
        self._q.put(("done", result))

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()
        self._q.put(("err", exc))

    # -- consumer side ------------------------------------------------------
    def events(self, timeout: Optional[float] = None):
        """Yield ("tok", int) per produced token, then one ("done",
        result).  Raises the failure; raises TimeoutError when no
        event arrives within `timeout` seconds."""
        while True:
            try:
                kind, payload = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("stream stalled") from None
            if kind == "err":
                raise payload
            yield kind, payload
            if kind == "done":
                return

    def tokens(self, timeout: Optional[float] = None):
        """Yield produced token ids; returns at end-of-stream."""
        for kind, payload in self.events(timeout=timeout):
            if kind == "tok":
                yield payload

    def drain_events(self, max_n: int = 1,
                     timeout: Optional[float] = None,
                     linger_s: float = 0.0):
        """Batched drain for the flushed transports (serve/wire.py):
        block up to `timeout` for the FIRST event, then greedily take
        whatever is already queued — lingering at most `linger_s` for
        stragglers — up to `max_n` events per call.  One queue wakeup
        amortizes over the whole batch instead of one lock round-trip
        per token.  Returns a list of (kind, payload) tuples ending
        early at any non-"tok" event; raises the stream's failure and
        TimeoutError exactly like `events()`.  `max_n=1, linger_s=0`
        reproduces the unbatched behavior bit-for-bit."""
        try:
            evs = [self._q.get(timeout=timeout)]
        except queue.Empty:
            raise TimeoutError("stream stalled") from None
        if evs[0][0] == "err":
            raise evs[0][1]
        limit = max(int(max_n), 1)
        wait_until = (time.monotonic() + max(float(linger_s), 0.0)
                      if linger_s and linger_s > 0 else None)
        while len(evs) < limit and evs[-1][0] == "tok":
            try:
                if wait_until is None:
                    ev = self._q.get_nowait()
                else:
                    rem = wait_until - time.monotonic()
                    if rem <= 0:
                        ev = self._q.get_nowait()
                    else:
                        ev = self._q.get(timeout=rem)
            except queue.Empty:
                break
            if ev[0] == "err":
                # surface the failure only after the caller has
                # consumed the tokens drained before it: a mid-batch
                # error must not eat already-produced tokens
                evs.append(("failed", ev[1]))
                break
            evs.append(ev)
        return evs

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._done.wait(timeout):
            raise TimeoutError("request still queued/running")
        if self._error is not None:
            raise self._error
        return self._result


@dataclass
class _CBRequest:
    tokens: np.ndarray            # (plen,) int32
    plen: int
    max_new: int
    nblocks: int                  # conservative reservation
    ticket: StreamTicket
    t_submit: float
    deadline: Optional[float]
    corr: str
    priority: str = "interactive"
    tenant: str = "default"
    cancel_event: Optional[threading.Event] = None
    # trace context captured at submit — the prefill runs on the
    # scheduler loop thread, so its span needs an explicit anchor to
    # land in the submitting request's trace
    link: Any = None
    t_admit: float = 0.0
    produced: List[int] = field(default_factory=list)


class ContinuousScheduler:
    """See module docstring.  One daemon loop thread; `submit` is
    called from any number of frontend threads."""

    def __init__(self, engine: InferenceEngine,
                 stats: Optional[ServeStats] = None, log_fn=print,
                 backoff: Optional[faults.Backoff] = None,
                 tenancy: Optional[TenantRegistry] = None):
        if not engine.spec.cb_on:
            raise ValueError("ContinuousScheduler needs a cb=on "
                             "ServeSpec")
        self.engine = engine
        self.spec = engine.spec
        self.stats = stats if stats is not None else engine.stats
        self.log = log_fn
        self._backoff = backoff if backoff is not None else \
            faults.Backoff(base=0.05, cap=2.0, seed=self.spec.seed)
        self.tenancy = tenancy if tenancy is not None \
            else TenantRegistry()
        self.kv: Optional[PagedKVCache] = None
        self._pending: deque = deque()
        self._cv = threading.Condition()
        self._req_ids = itertools.count(1)
        # per-class shed streaks/backoffs (see serve/qos.py); the
        # interactive stream matches the old single-class behavior
        self._class_backoffs = qos.ClassBackoffs(
            base=getattr(self._backoff, "base", 0.05),
            cap=getattr(self._backoff, "cap", 2.0),
            seed=getattr(self._backoff, "seed", self.spec.seed))
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # slot state (numpy, scheduler-thread-owned)
        s = self.spec.cb_slots
        self._active = np.zeros((s,), bool)
        self._ntoks = np.zeros((s,), np.int32)
        self._last = np.zeros((s,), np.int32)
        self._slot_req: List[Optional[_CBRequest]] = [None] * s

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ContinuousScheduler":
        if self._thread is not None:
            return self
        if self.engine.params is None:
            raise RuntimeError("engine has no params; call load()")
        spec = self.spec
        if spec.cb_pool_blocks - 1 < spec.cb_blocks_per_slot:
            # a pool that cannot hold even one worst-case request
            # would wedge every admission; refuse loudly at startup
            raise ValueError(
                f"cb_blocks={spec.cb_pool_blocks} cannot hold one "
                f"worst-case request ({spec.cb_blocks_per_slot} "
                f"blocks + null)")
        if self.kv is None:
            # the engine's pools: its captured programs write them
            self.kv = PagedKVCache(
                self.engine.net, num_slots=spec.cb_slots,
                max_blocks_per_slot=spec.cb_blocks_per_slot,
                num_blocks=spec.cb_pool_blocks,
                block_len=spec.cb_block_len,
                dtype=params_dtype(self.engine.params),
                device=self.engine.device, pools=self.engine.cb_pools)
            self.stats.gauge("cb_slot_capacity", spec.cb_slots)
            self.stats.gauge("cb_blocks_total", self.kv.usable_blocks)
            # MemoryWatch: the pools, from the same block geometry
            # init_pools used (analytic == actual here)
            perf.set_memory(
                "kv_pool",
                pool_bytes(self.engine.net, spec.cb_pool_blocks,
                           spec.cb_block_len,
                           params_dtype(self.engine.params)),
                scope=self.engine._perf_scope)
        # capture on this thread, before the loop thread works on the
        # card (a no-op once warmed)
        self.engine.warmup(("generate",))
        self._stop = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-cb", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
            self.stats.gauge("queue_depth", 0)
        for r in leftovers:
            self.stats.count("failed")
            r.ticket._fail(RuntimeError("server shutting down"))
        for s, r in enumerate(self._slot_req):
            if r is not None:
                self._retire(s, "shutdown", self.engine.params_step)

    # -- admission ----------------------------------------------------------
    def submit(self, tokens, timeout: Optional[float] = None,
               max_new: Optional[int] = None,
               deadline: Optional[float] = None,
               priority: str = "interactive",
               tenant: Optional[str] = None,
               cancel_event: Optional[threading.Event] = None,
               resume_from: int = 0) -> StreamTicket:
        """Admit one generate request.  `max_new` caps this request's
        generation (clamped to spec.max_new_tokens).  `deadline`
        (absolute monotonic; wins over `timeout`) is the request's
        end-to-end budget — dead on arrival is refused before any
        queue or engine work (`expired_on_arrival`); `priority` drives
        brownout admission; a set `cancel_event` drops the request at
        the next scheduler touch (queued or mid-decode, counted
        `cancelled`).  Raises ValueError for a never-servable prompt
        or unknown priority (fail fast, the HTTP layer's 400),
        `Overloaded` when the pending queue is full or brownout sheds
        this class.

        `resume_from=n` re-admits a failed-over stream: `tokens` is
        (original prompt ‖ the n tokens already emitted), the fresh
        prefill re-derives the continuation (greedy decode is
        bit-deterministic given fingerprint + prefix, the paged-vs-
        contiguous parity property), and the ticket numbers its output
        from absolute index n so the router can splice and dedupe.  Only
        max_new - n MORE tokens are generated and the block
        reservation covers exactly (grown prompt + remainder).  A
        resume past `max_new` or past an already-emitted EOS is a
        fast 400 (counted `rejected`, zero engine steps) — the
        original stream was already complete."""
        spec = self.spec
        tenant = self.tenancy.label(tenant)
        arr = np.asarray(tokens, np.int32).reshape(-1)
        if arr.size < 1:
            self.stats.count("rejected")
            raise ValueError("empty prompt")
        if arr.size > spec.cb_max_prompt_len:
            self.stats.count("rejected")
            raise ValueError(
                f"prompt length {arr.size} exceeds the cb prompt cap "
                f"({spec.cb_max_prompt_len}); not servable")
        mn = int(max_new) if max_new is not None else \
            int(spec.max_new_tokens)
        if mn < 1:
            self.stats.count("rejected")
            raise ValueError(f"max_new must be >= 1, got {mn}")
        mn = min(mn, int(spec.max_new_tokens))
        resume_from = int(resume_from)
        if resume_from < 0:
            self.stats.count("rejected")
            raise ValueError(f"resume_from must be >= 0, got "
                             f"{resume_from}")
        if resume_from > 0:
            if resume_from >= mn:
                self.stats.count("rejected")
                raise ValueError(
                    f"resume_from {resume_from} is past max_new {mn}; "
                    f"the stream already completed")
            if resume_from > arr.size:
                self.stats.count("rejected")
                raise ValueError(
                    f"resume_from {resume_from} exceeds the "
                    f"{arr.size}-token prompt+prefix")
            if spec.eos_id is not None and \
                    np.any(arr[-resume_from:] == int(spec.eos_id)):
                self.stats.count("rejected")
                raise ValueError(
                    f"resume_from {resume_from} is past EOS: the "
                    f"emitted prefix already contains eos_id "
                    f"{spec.eos_id}")
            mn = mn - resume_from     # only the remainder decodes
            self.stats.count("resumed")
        nblocks = -(-(int(arr.size) + mn) // int(spec.cb_block_len))
        deadline = qos.resolve_deadline(timeout, deadline,
                                        spec.request_timeout_s)
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            # dead on arrival: refuse before it queues — zero engine
            # steps burned on a client that already gave up
            self.stats.count("expired_on_arrival")
            raise DeadlineExpired(
                f"dead on arrival: deadline passed "
                f"{now - deadline:.3f}s before admission")
        # inherit the caller's correlation chain when one is open on
        # this thread (the HTTP handler's serve.request span) instead
        # of minting a fresh cbreq-N
        corr = obs.current_corr() or f"cbreq-{next(self._req_ids)}"
        link = obs.trace_context()
        req = _CBRequest(tokens=arr, plen=int(arr.size), max_new=mn,
                         nblocks=nblocks,
                         ticket=StreamTicket(corr,
                                             first_index=resume_from),
                         t_submit=now, deadline=deadline, corr=corr,
                         priority=priority, tenant=tenant,
                         cancel_event=cancel_event, link=link)
        quota = self.tenancy.queue_quota(tenant, spec.queue_capacity)
        with obs.span("scheduler.admit", corr=corr,
                      plen=int(arr.size), max_new=mn,
                      priority=priority, tenant=tenant):
            try:
                faults.maybe_fault("serve.admit")
            except faults.FaultError as e:
                self._shed(f"admission fault: {e}", corr=corr,
                           priority=priority, tenant=tenant)
            with self._cv:
                if self._stop:
                    raise RuntimeError("scheduler is stopped")
                depth = len(self._pending)
                tdepth = sum(1 for r in self._pending
                             if r.tenant == tenant)
                if depth >= spec.queue_capacity or \
                        tdepth >= quota or \
                        not self._brownout_admits(priority, depth,
                                                  tenant):
                    pass          # shed outside the happy path below
                else:
                    self._pending.append(req)
                    self._class_backoffs.reset(priority,
                                               tenant=tenant)
                    self.stats.count("submitted")
                    self.stats.tenants.count("submitted", tenant)
                    self.stats.gauge("queue_depth", len(self._pending))
                    self._cv.notify()
                    return req.ticket
            if depth >= spec.queue_capacity:
                why = f"queue full ({spec.queue_capacity} requests)"
            elif tdepth >= quota:
                why = (f"tenant {tenant} queue quota full "
                       f"({tdepth}/{quota} of {spec.queue_capacity})")
            else:
                why = (f"brownout: queue {depth}/"
                       f"{spec.queue_capacity} sheds {priority}")
            self._shed(why, corr=corr, priority=priority,
                       tenant=tenant)

    def _brownout_admits(self, priority: str, depth: int,
                         tenant: str = "default") -> bool:
        """Class-aware admission under pressure: best_effort is shed
        once the pending queue is `brownout_be_frac` full, batch at
        `brownout_batch_frac`; interactive rides to the cap.  A
        tenant's spec can tighten either fraction for ITS traffic."""
        if priority == "interactive":
            return True
        be, batch = self.tenancy.brownout_fracs(
            tenant, self.spec.brownout_be_frac,
            self.spec.brownout_batch_frac)
        frac = be if priority == "best_effort" else batch
        return depth < max(int(frac * self.spec.queue_capacity), 1)

    def _shed(self, why: str, corr: Optional[str] = None,
              priority: str = "interactive",
              tenant: str = "default") -> None:
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

    # -- the loop -----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._pending and not self._active.any()
                       and not self._stop):
                    self._cv.wait(0.05)
                if self._stop:
                    return
            self._iterate()

    def _iterate(self) -> None:
        """One scheduler step: expire, admit, decode, account."""
        now = time.monotonic()
        self._expire_pending(now)
        # ONE hold covers this step's prefills AND decode — the per-step
        # no-tear guarantee (see module docstring)
        with self.engine.hold() as (params, step_no):
            try:
                self._admit_pending(params, step_no)
                if self._active.any():
                    self._decode_step(params, step_no)
            except Exception as e:  # noqa: BLE001 — fail step, keep serving
                self._fail_step(e)
                return
        if self.kv is not None:
            self.stats.observe_cb_step(int(self._active.sum()),
                                       self.kv.blocks_in_use)
            self.stats.gauge("cb_blocks_in_use", self.kv.blocks_in_use)

    def _expire_pending(self, now: float) -> None:
        with self._cv:
            keep: deque = deque()
            expired: List[_CBRequest] = []
            cancelled: List[_CBRequest] = []
            for r in self._pending:
                if r.cancel_event is not None and \
                        r.cancel_event.is_set():
                    cancelled.append(r)
                elif r.deadline is not None and now > r.deadline:
                    expired.append(r)
                else:
                    keep.append(r)
            self._pending = keep
            self.stats.gauge("queue_depth", len(self._pending))
        for r in cancelled:
            self.stats.count("cancelled")
            r.ticket._fail(Cancelled(
                "cancelled by caller while queued"))
        for r in expired:
            self.stats.count("expired")
            r.ticket._fail(DeadlineExpired(
                f"deadline passed after {now - r.t_submit:.3f}s in "
                f"queue"))

    def _admit_pending(self, params, step_no: int) -> None:
        """Admit the queue head while a slot AND its blocks are free.
        FIFO with one tenancy carve-out: a head blocked ONLY by its
        own tenant's slot/KV quota is stepped over (its quota is its
        own blast radius — it must not wedge the other tenants), but
        a head blocked by a GLOBAL resource (block pool too empty)
        still holds everything behind it, preserving the
        no-starvation guarantee for long prompts."""
        spec = self.spec
        while True:
            free = np.flatnonzero(~self._active)
            with self._cv:
                if not self._pending or free.size == 0:
                    return
                # per-tenant occupancy among the ACTIVE slots (slot
                # count + conservative block reservations), once per
                # admission round
                slots_t: Dict[str, int] = {}
                blocks_t: Dict[str, int] = {}
                for r in self._slot_req:
                    if r is not None:
                        slots_t[r.tenant] = \
                            slots_t.get(r.tenant, 0) + 1
                        blocks_t[r.tenant] = \
                            blocks_t.get(r.tenant, 0) + r.nblocks
                req = None
                for i, cand in enumerate(self._pending):
                    if not self.kv.can_admit(cand.nblocks):
                        # global pool pressure: the effective head
                        # waits, nothing overtakes it
                        return
                    squota = self.tenancy.slot_quota(
                        cand.tenant, spec.cb_slots)
                    bquota = self.tenancy.kv_quota(
                        cand.tenant, self.kv.usable_blocks)
                    if slots_t.get(cand.tenant, 0) + 1 > squota or \
                            blocks_t.get(cand.tenant, 0) + \
                            cand.nblocks > bquota:
                        continue  # ITS quota, not ours: step over
                    req = cand
                    del self._pending[i]
                    break
                if req is None:
                    return        # every pending head is quota-held
                self.stats.gauge("queue_depth", len(self._pending))
            # last-instant guard AFTER the pop, BEFORE any blocks or
            # engine work: an engine never prefills a request that is
            # already dead or cancelled
            now = time.monotonic()
            if req.cancel_event is not None and \
                    req.cancel_event.is_set():
                self.stats.count("cancelled")
                req.ticket._fail(Cancelled(
                    "cancelled by caller before prefill"))
                continue
            if req.deadline is not None and now >= req.deadline:
                self.stats.count("expired")
                req.ticket._fail(DeadlineExpired(
                    f"deadline passed after {now - req.t_submit:.3f}s "
                    f"in queue"))
                continue
            slot = int(free[0])
            req.t_admit = now
            row = self.kv.alloc(slot, req.nblocks)
            toks = np.zeros((1, spec.cb_prefill_len), np.int32)
            toks[0, :req.plen] = req.tokens
            try:
                with obs.span("scheduler.prefill", corr=req.corr,
                              trace=req.link[0] if req.link else None,
                              parent=req.link[1] if req.link else None,
                              slot=slot, plen=req.plen):
                    tok0, self.kv.pools = self.engine.run_cb_prefill(
                        params, self.kv.pools, toks, req.plen,
                        row[:spec.cb_prefill_len // spec.cb_block_len])
            except Exception as e:  # noqa: BLE001 — fail req, keep going
                # the slot is not in _slot_req yet: clean it here so
                # the blocks cannot leak, fail only this request
                self.kv.free(slot)
                self.stats.count("failed")
                self.stats.observe_batch_failure()
                self.log(f"warning: cb prefill failed "
                         f"({type(e).__name__}: {e}); request "
                         f"{req.corr} failed, server continues")
                req.ticket._fail(RuntimeError(f"prefill failed: {e}"))
                return
            self._slot_req[slot] = req
            self._active[slot] = True
            self._ntoks[slot] = req.plen
            self._last[slot] = tok0
            req.produced.append(tok0)
            req.ticket._emit(tok0)
            self._maybe_retire(slot, tok0, step_no,
                               time.monotonic())

    def _decode_step(self, params, step_no: int) -> None:
        faults.maybe_fault("serve.batch")
        nxt, self.kv.pools = self.engine.run_cb_decode(
            params, self.kv.pools, self._last, self._ntoks,
            self.kv.table_array())
        now = time.monotonic()
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            self._ntoks[slot] += 1
            tok = int(nxt[slot])
            self._last[slot] = tok
            req = self._slot_req[slot]
            req.produced.append(tok)
            req.ticket._emit(tok)
            self._maybe_retire(slot, tok, step_no, now)

    def _maybe_retire(self, slot: int, tok: int, step_no: int,
                      now: float) -> None:
        req = self._slot_req[slot]
        eos = self.spec.eos_id
        if req.cancel_event is not None and req.cancel_event.is_set():
            # hedge loser mid-decode: free the slot THIS step — the
            # winner's fleet keeps the capacity, not a dead stream
            self._retire(slot, "cancelled", step_no)
        elif eos is not None and tok == eos:
            self._retire(slot, "eos", step_no)
        elif len(req.produced) >= req.max_new:
            self._retire(slot, "length", step_no)
        elif req.deadline is not None and now > req.deadline:
            self._retire(slot, "deadline", step_no)

    def _retire(self, slot: int, finish: str, step_no: int) -> None:
        req = self._slot_req[slot]
        self.kv.free(slot)
        self._active[slot] = False
        self._ntoks[slot] = 0
        self._last[slot] = 0
        self._slot_req[slot] = None
        now = time.monotonic()
        if finish == "shutdown":
            self.stats.count("failed")
            req.ticket._fail(RuntimeError("server shutting down"))
            return
        if finish == "cancelled":
            # not a completion, not a failure: no latency sample, no
            # strike — the caller asked for it (hedge loser)
            self.stats.count("cancelled")
            obs.emit_event("serve.cb_retire", corr=req.corr,
                           finish=finish, tokens=len(req.produced),
                           slot=slot)
            req.ticket._fail(Cancelled(
                "cancelled by caller mid-decode"))
            return
        self.stats.observe_latency(now - req.t_submit)
        self.stats.observe_request(req.t_admit - req.t_submit,
                                   now - req.t_admit,
                                   len(req.produced))
        self.stats.tenants.count("completed", req.tenant)
        self.stats.tenants.observe_latency(now - req.t_submit,
                                           req.tenant)
        obs.emit_event("serve.cb_retire", corr=req.corr,
                       finish=finish, tokens=len(req.produced),
                       slot=slot, tenant=req.tenant)
        req.ticket._resolve({"tokens": list(req.produced),
                             "step": step_no, "finish": finish,
                             "slots": self.spec.cb_slots})

    def _fail_step(self, e: BaseException) -> None:
        """A program call raised: fail every in-flight request, free
        everything, keep the loop alive (the batcher's degrade
        story)."""
        n = int(self._active.sum())
        self.stats.count("failed", n)
        self.stats.observe_batch_failure()
        self.log(f"warning: cb decode step failed "
                 f"({type(e).__name__}: {e}); {n} request(s) failed, "
                 f"server continues")
        err = (e if isinstance(e, faults.FaultError)
               else RuntimeError(f"decode step failed: {e}"))
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._slot_req[slot]
            self.kv.free(slot)
            self._active[slot] = False
            self._ntoks[slot] = 0
            self._last[slot] = 0
            self._slot_req[slot] = None
            req.ticket._fail(err)

    # -- reads --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out = {"pending": len(self._pending),
               "active_slots": int(self._active.sum()),
               "slots": self.spec.cb_slots}
        if self.kv is not None:
            out["kv"] = self.kv.snapshot()
        return out
