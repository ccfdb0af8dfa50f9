"""Router-side durable decode sessions: the journal that makes a
stream survive engine death (docs/SERVING.md, "Mid-stream failover").

A stream's transport must not be its unit of failure ("RPC Considered
Harmful", arxiv 1805.08430): once tokens have flowed, the old commit
point turned every engine crash, silent stall, or drain-timeout into a
mid-stream RuntimeError on exactly the long, expensive streams.  The
state worth keeping alive is tiny and lives HERE, one hop above the
engines: the prompt, every emitted token with an absolute sequence
number, the serving fingerprint (checkpoint step), and the QoS
envelope (deadline / priority / max_new).

That journal is sufficient to resume because greedy decode is
bit-deterministic given (fingerprint, prompt, tokens-so-far) — the
same property the paged==contiguous parity rig proved.  On failover
the router re-admits (prompt ‖ emitted-prefix) as a fresh prefill on a
*different* engine pinned to the same fingerprint with
`resume_from=n`; the new leg numbers its tokens from n, and the
consumer loop dedupes by sequence number so the client sees every
index exactly once — at-most-once delivery, bit-identical to the
uninterrupted stream.

Lifecycle (the JOURNALED → FAILED-OVER → SPLICED arc in SERVING.md):

    JOURNALED    every active stream; tokens recorded as they pass
    FAILED-OVER  a leg died (transport break, idle watchdog,
                 drain-timeout kick) and a resume leg was admitted
    SPLICED      the resumed leg finished; the terminal `done` event
                 carries the FULL token list and `spliced: true`
    DONE/FAILED  terminal either way; `failover_stale` is the honest
                 terminal finish when no same-fingerprint engine
                 remains to resume onto

Every leg writes into its session's ONE event queue tagged with its
leg identity; a stalled old leg that wakes up after failover can only
produce already-journaled indices (dropped by the dedupe, counted
`dup_tokens`) or stale control events (ignored: wrong leg tag) — a
zombie leg can never corrupt the client stream.

The port's own copy of `singa_tpu/serve/session.py` (pure Python and
numpy there too).  On the card a resume leg's K/V come from a prefill,
the dead leg's from decode steps: products of another M, so a spliced
token may differ from the uninterrupted one where the top-2 logit gap
is at rounding level (the CPU splice is bit-identical).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

STREAM_STATES = ("journaled", "failed_over", "spliced", "done",
                 "failed", "failover_stale")

#: terminal-session retention defaults (SessionManager.configure):
#: closed sessions are kept briefly so a reconnecting client can
#: replay the finished stream (exactly-once attach), then evicted
SESSION_TTL_S = 300.0
SESSION_CAP = 1024


class StreamStats:
    """Fleet-wide stream-session counters, exported as
    `singa_stream_*` (RouterStats mold, failover edition)."""

    FIELDS = ("opened", "done", "failed", "failovers", "resumed",
              "spliced", "dup_tokens", "gap_events", "idle_timeouts",
              "kicked", "resume_faults", "resume_denied",
              "failover_stale", "sessions_evicted", "attached")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def count(self, fieldname: str, n: int = 1) -> None:
        with self._lock:
            # getattr validates the field exactly like ServeStats.gauge
            setattr(self, fieldname, getattr(self, fieldname) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}

    def register_into(self, registry,
                      prefix: str = "singa_stream") -> None:
        from ..obs.metrics import Sample

        def collect():
            snap = self.snapshot()
            return [Sample(f"{prefix}_{k}_total", "counter",
                           f"stream session counter {k!r}",
                           float(snap[k])) for k in self.FIELDS]

        registry.register_collector(collect)


class StreamSession:
    """One stream's durable state: everything needed to re-derive the
    continuation on another engine, and the dedupe cursor that makes
    the splice at-most-once."""

    def __init__(self, sid: str, prompt: np.ndarray,
                 max_new: Optional[int], deadline: Optional[float],
                 priority: str, engine: str, step: int,
                 corr: Optional[str] = None, trace=None,
                 tenant: str = "default",
                 family: Optional[str] = None):
        self.sid = sid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = (int(max_new) if max_new is not None else None)
        self.deadline = deadline
        self.priority = priority
        self.engine = engine          # current leg's engine
        self.step = int(step)         # with `family`, the serving
        self.family = family          # fingerprint (family, step) —
                                      # a resume must match BOTH
        # the tenant that owns the stream: every failover resume
        # charges ITS retry budget, and the splice accounting lands
        # on its singa_tenant_* series
        self.tenant = tenant
        # trace context of the originating request — `(trace_id,
        # root_span_id)` — so a failover leg admitted seconds later on
        # a different thread still lands in the SAME trace, tagged
        # with the originating corr (the old legs minted fresh chains
        # and the splice was invisible in any trace)
        self.corr = corr
        self.trace = trace
        self.emitted: List[int] = []  # the journal: token i at [i]
        self.next_i = 0               # dedupe cursor: next index owed
        self.resumes = 0
        self.state = "journaled"
        self.t0 = time.monotonic()
        # ONE queue for the session's whole life; every leg pumps into
        # it tagged with its leg object, kicks are tagged None — see
        # module docstring for why a zombie leg is harmless
        self.q: "queue.Queue" = queue.Queue()
        # replay buffer (crash recovery): a WAL-recovered stream has
        # no connected client, so the recovery driver parks its
        # spliced events here and a reconnecting client (attach by
        # X-Session-Id) drains them exactly-once from `resume_from`
        self.attachable = False
        self.replay: List[Dict[str, Any]] = []
        self.replay_done = False
        self.replay_cond = threading.Condition()

    def replay_append(self, ev: Dict[str, Any]) -> None:
        with self.replay_cond:
            self.replay.append(ev)
            self.replay_cond.notify_all()

    def replay_finish(self) -> None:
        with self.replay_cond:
            self.replay_done = True
            self.replay_cond.notify_all()

    def attach(self, resume_from: int = 0
               ) -> Iterator[Dict[str, Any]]:
        """Drain the replay buffer from token index `resume_from` —
        the reconnect path.  Token events below `resume_from` are
        skipped (the client already has them: exactly-once across
        the reconnect); control/terminal events always pass."""
        if not self.attachable:
            raise ValueError(f"session {self.sid!r} not attachable")
        pos = 0
        while True:
            with self.replay_cond:
                while (pos >= len(self.replay)
                       and not self.replay_done):
                    self.replay_cond.wait(0.25)
                evs = self.replay[pos:]
                done = self.replay_done
            pos += len(evs)
            for ev in evs:
                if ("token" in ev
                        and int(ev.get("i", 0)) < int(resume_from)):
                    continue
                yield ev
            if done:
                return

    def record(self, token: int) -> None:
        """Journal token `next_i` (caller already deduped by index)."""
        self.emitted.append(int(token))
        self.next_i += 1

    def resume_tokens(self) -> np.ndarray:
        """The re-admission prompt: original prompt ‖ emitted prefix —
        with the fingerprint, the complete decode state."""
        if not self.emitted:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.emitted, np.int32)])

    def kick(self, why: str) -> None:
        """Ask the consumer loop to fail over NOW (drain-timeout
        during scale-down): delivered through the session queue so it
        interrupts even a consumer parked waiting for the next
        token."""
        self.q.put((None, "kick", why))

    def snapshot(self) -> Dict[str, Any]:
        return {"sid": self.sid, "engine": self.engine,
                "step": self.step, "family": self.family,
                "tenant": self.tenant, "state": self.state,
                "emitted": len(self.emitted),
                "resumes": self.resumes,
                "age_s": round(time.monotonic() - self.t0, 3)}


class SessionManager:
    """The router's registry of live stream sessions: opens/closes
    them, owns the `singa_stream_*` stats, and fans a drain-timeout
    kick out to every session still on the doomed engine."""

    def __init__(self):
        self.stats = StreamStats()
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}
        # terminal sessions retained (bounded) for reconnect replay:
        # insertion order == close order, so TTL/cap eviction pops
        # from the front — `kick_engine` never scans these, keeping
        # it O(live) not O(ever-opened)
        self._terminal: "OrderedDict[str, Tuple[StreamSession, float]]" \
            = OrderedDict()
        self._ids = itertools.count(1)
        self.wal = None               # SessionWal when durability is on
        self.epoch = 0                # router epoch (0 = no WAL)
        self.ttl_s = SESSION_TTL_S
        self.cap = SESSION_CAP

    def configure(self, wal=None, epoch: int = 0,
                  ttl_s: Optional[float] = None,
                  cap: Optional[int] = None) -> None:
        """Attach the durability plumbing (fleet wires this before
        traffic): the WAL every open/token/close journals into, the
        router epoch that namespaces fresh sids (a restarted router
        must never mint a sid colliding with a journaled one), and
        the terminal-retention bounds."""
        self.wal = wal
        self.epoch = int(epoch)
        if ttl_s is not None:
            self.ttl_s = max(float(ttl_s), 0.0)
        if cap is not None:
            self.cap = max(int(cap), 0)

    def open(self, prompt, max_new: Optional[int],
             deadline: Optional[float], priority: str,
             engine: str, step: int, corr: Optional[str] = None,
             trace=None, tenant: str = "default",
             family: Optional[str] = None, sid: Optional[str] = None,
             emitted: Optional[List[int]] = None) -> StreamSession:
        if sid is None:
            n = next(self._ids)
            sid = (f"s{self.epoch}-{n}" if self.epoch
                   else f"stream-{n}")
        s = StreamSession(sid, prompt, max_new, deadline, priority,
                          engine, step, corr=corr, trace=trace,
                          tenant=tenant, family=family)
        # a recovered session re-enters with its journaled prefix
        for t in (emitted or []):
            s.record(int(t))
        with self._lock:
            self._sessions[sid] = s
            self._terminal.pop(sid, None)
        self.stats.count("opened")
        if self.wal is not None:
            rem = (max(deadline - time.monotonic(), 0.0)
                   if deadline is not None else None)
            # write-ahead of the first token: the open record is what
            # lets a post-crash replay re-derive the decode.  A
            # recovered open re-journals prefix and all into the NEW
            # epoch's WAL, so each journal is self-contained.
            self.wal.append_open(sid, s.prompt.tolist(), s.max_new,
                                 priority, tenant, family, step, rem)
            for i, t in enumerate(s.emitted):
                self.wal.append_tok(sid, i, t)
        self._evict()
        return s

    def close(self, session: StreamSession, state: str) -> None:
        session.state = state
        with self._lock:
            self._sessions.pop(session.sid, None)
            self._terminal[session.sid] = (
                session, time.monotonic() + self.ttl_s)
            self._terminal.move_to_end(session.sid)
        if self.wal is not None:
            self.wal.append_close(session.sid, state)
        if state in ("done", "spliced"):
            self.stats.count("done")
        elif state == "failover_stale":
            self.stats.count("failover_stale")
        else:
            self.stats.count("failed")
        self._evict()

    def get(self, sid: str) -> Optional[StreamSession]:
        """Live session, or a retained terminal one (reconnect)."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                return s
            ent = self._terminal.get(sid)
            return ent[0] if ent is not None else None

    def register_terminal(self, rec: Dict[str, Any]
                          ) -> StreamSession:
        """Re-register a stream the WAL shows finished BEFORE the
        crash: replaying it is a pure journal read — a reconnecting
        client gets the journaled tokens + terminal event, and no
        engine ever re-decodes a finished stream."""
        s = StreamSession(
            rec["sid"], np.asarray(rec.get("prompt") or [], np.int32),
            rec.get("max_new"), None,
            rec.get("priority") or "interactive",
            rec.get("engine") or "", int(rec.get("step", -1)),
            tenant=rec.get("tenant") or "default",
            family=rec.get("family"))
        for t in rec.get("emitted") or []:
            s.record(int(t))
        s.state = rec.get("terminal") or "done"
        s.attachable = True
        for i, t in enumerate(s.emitted):
            s.replay.append({"token": int(t), "i": i})
        finish = ("length" if s.state in ("done", "spliced")
                  else s.state)
        s.replay.append({"done": True, "finish": finish,
                         "n": len(s.emitted),
                         "tokens": list(s.emitted),
                         "sid": s.sid, "step": s.step,
                         "replayed": True})
        s.replay_done = True
        with self._lock:
            self._terminal[s.sid] = (
                s, time.monotonic() + self.ttl_s)
        return s

    def _evict(self) -> None:
        """Lazy TTL/cap eviction of retained terminal sessions —
        the bound that keeps the manager O(live) forever."""
        now = time.monotonic()
        evicted = 0
        with self._lock:
            while self._terminal:
                _, (_, expiry) = next(iter(self._terminal.items()))
                if expiry <= now or len(self._terminal) > self.cap:
                    self._terminal.popitem(last=False)
                    evicted += 1
                else:
                    break
        if evicted:
            self.stats.count("sessions_evicted", evicted)

    def kick_engine(self, engine: str, why: str) -> int:
        """Fail every live session on `engine` over to a sibling
        (scale-down drain timed out: the engine is leaving whether its
        streams finished or not).  Returns how many were kicked."""
        with self._lock:
            doomed = [s for s in self._sessions.values()
                      if s.engine == engine]
        for s in doomed:
            s.kick(why)
        if doomed:
            self.stats.count("kicked", len(doomed))
        return len(doomed)

    def active(self) -> int:
        with self._lock:
            return len(self._sessions)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            sessions = [s.snapshot() for s in self._sessions.values()]
            retained = len(self._terminal)
        out: Dict[str, Any] = dict(self.stats.snapshot())
        out["active"] = len(sessions)
        out["terminal_retained"] = retained
        out["sessions"] = sessions
        return out
