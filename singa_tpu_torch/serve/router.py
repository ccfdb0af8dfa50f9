"""Fleet router: health-driven dispatch over N engine workers.

One engine per process caps serving throughput at one chip's tok/s and
makes every crash a 100% outage; the router is the horizontal half of
the north star ("millions of users") and the modern answer to the
reference's ZeroMQ server pool (PAPER.md L4) — survive partial failure
by construction, the TensorFlow-paper argument (arxiv 1605.08695).

Three moving parts:

  * `EngineHandle` — the uniform worker surface.  `LocalEngineHandle`
    wraps an in-process `InferenceServer` (threads: the CPU-test and
    single-machine shape); `HttpEngineHandle` speaks to a separate
    `singa_tpu_torch.main serve --pinned` process (or the JAX package's)
    over its HTTP surface
    (/healthz, /stats, /generate, /predict, /admin/reload) — the
    subprocess deployment whose membership comes from
    `parallel.bootstrap.parse_hostfile`.
  * `Router` — per-request dispatch to the least-loaded healthy
    engine (in-flight + last-probed queue depth), with
    retry-on-other-engine: an engine failure (connection refused, a
    500, an injected `fleet.dispatch` fault) charges the engine a
    strike and the request moves on; the client sees a failure only
    when every admissible engine has been tried.  `Overloaded` from
    one engine is load, not failure — the request retries elsewhere
    without a strike.  When NO engine can take the request the router
    itself sheds with `Overloaded` + an escalating Backoff
    `Retry-After`, mirroring the MicroBatcher's admission story one
    level up.
  * the probe loop — every `probe_period_s` each member's
    /healthz + ServeStats are read; a degraded verdict pulls the
    engine out of dispatch (it re-enters the moment it reports ok),
    while hard probe failures accumulate strikes toward quarantine.
    Quarantine/readmission mirrors `ReplicaSet`'s poisoned-round
    policy: `quarantine_after` consecutive strikes bench the engine
    for a `utils.faults.Backoff` delay that doubles on each
    consecutive re-quarantine, and a clean probe after the bench
    readmits it (counted, evented — `fleet.quarantine` /
    `fleet.readmit`).

Rollout (canary / promote / rollback) rides on top of this in
`fleet.py`; the router only answers "who is healthy and least loaded
right now" and "move this request somewhere else".

The port's own copy of `singa_tpu/serve/router.py`, JAX-free there too.
An in-process member's engine serves on the card; the router itself is
host code, and either package's router adopts the other's workers over
HTTP and the binary wire (the protocols are the same byte for byte).
"""

from __future__ import annotations

import dataclasses
import http.client
import inspect
import itertools
import json
import queue
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import obs
from ..utils import faults
from . import qos
from .batcher import Cancelled, DeadlineExpired, Overloaded
from .session import SessionManager
from .tenancy import TenantCounts, TenantRegistry


class EngineUnavailable(RuntimeError):
    """The chosen engine could not take the request at all (process
    dead, connection refused, handler crashed) — retried on another
    engine and charged to this one as a strike."""


class UnknownModel(ValueError):
    """The requested model family is served by NO member of the fleet:
    an honest fast rejection (the HTTP layer's 404) decided at
    admission, before any engine is picked — never a strike against an
    engine, never a shed, never a Retry-After (waiting will not make
    the family appear).  A ValueError subclass so duck-typed callers
    that predate model-aware routing still treat it as an unservable
    request, not an engine failure."""


class _FailoverStale(RuntimeError):
    """No engine pinned to the session's fingerprint remains, but
    OTHER fingerprints are serving — resuming there would break
    bit-determinism, so the stream terminates honestly with
    `finish: "failover_stale"` instead of splicing a lie."""


class LameDuck(RuntimeError):
    """The router is draining for handoff: in-flight streams finish,
    NEW admissions are refused with a Retry-After pointing at the
    successor (the HTTP layer's 409).  Not a shed — capacity exists,
    it just lives behind the successor's address now."""

    def __init__(self, msg: str, successor: Optional[str] = None,
                 retry_after: float = 0.5):
        super().__init__(msg)
        self.successor = successor
        self.retry_after = float(retry_after)


class UnknownSession(KeyError):
    """A reconnect presented a session id the router does not hold —
    never journaled, or already evicted past the retention TTL/cap.
    The HTTP layer's 410: retrying the SAME sid cannot succeed."""


@dataclass(frozen=True)
class RouterSpec:
    """Router config grammar (`--fleet_spec`, the ServeSpec mold):
    comma/semicolon-separated `key=value`."""
    probe_period_s: float = 0.25   # health-probe cadence per engine
    quarantine_after: int = 2      # consecutive strikes -> quarantine
    readmit_base_s: float = 0.25   # Backoff base for the bench time
    readmit_cap_s: float = 10.0    # Backoff cap
    max_attempts: int = 0          # engines tried per request (0 = all)
    request_timeout_s: float = 5.0
    seed: int = 0
    hedge: str = "on"              # hedged dispatch ("Tail at Scale")
    hedge_min_s: float = 0.05      # clamp on the p95-derived delay
    hedge_max_s: float = 1.0
    retry_budget_ratio: float = 0.1   # retries+hedges per primary
    retry_budget_burst: float = 16.0  # token-bucket cap
    brownout_shed_rate: float = 0.1   # capacity-shed rate engaging
                                      # brownout (0 = never)
    resume: str = "on"             # mid-stream failover: resume a
                                   # journaled stream on a sibling
                                   # ("off" = terminal errors)
    stream_idle_s: float = 0.0     # per-stream idle watchdog: no
                                   # token for this long -> failover
                                   # (0 = off; catches engine.stall-
                                   # style silent stragglers)
    wal: str = "on"                # durable session WAL (off = the
                                   # in-memory-only journal)
    wal_group_tokens: int = 64     # group-commit: fsync every N
    wal_group_ms: float = 25.0     # journaled records / T ms
    state_snapshot_s: float = 0.5  # control-state snapshot cadence
    session_ttl_s: float = 300.0   # terminal-session retention TTL
    session_cap: int = 1024        # ... and count cap
    flush_tokens: int = 8          # frontend token-flush batching
    flush_ms: float = 4.0          # (serve/wire.py LineCoalescer):
                                   # tokens per ndjson chunk / linger.
                                   # First token always flushes alone

    def __post_init__(self):
        if int(self.quarantine_after) < 1:
            raise ValueError(f"quarantine_after must be >= 1, got "
                             f"{self.quarantine_after}")
        if float(self.probe_period_s) <= 0:
            raise ValueError(f"probe_period_s must be > 0, got "
                             f"{self.probe_period_s}")
        if str(self.hedge) not in ("on", "off"):
            raise ValueError(f"hedge must be on|off, got {self.hedge!r}")
        if not (0 < float(self.hedge_min_s) <= float(self.hedge_max_s)):
            raise ValueError(
                f"need 0 < hedge_min_s <= hedge_max_s, got "
                f"{self.hedge_min_s}/{self.hedge_max_s}")
        if float(self.retry_budget_ratio) < 0 or \
                float(self.retry_budget_burst) < 0:
            raise ValueError("retry budget ratio/burst must be >= 0")
        if str(self.resume) not in ("on", "off"):
            raise ValueError(f"resume must be on|off, got "
                             f"{self.resume!r}")
        if float(self.stream_idle_s) < 0:
            raise ValueError(f"stream_idle_s must be >= 0, got "
                             f"{self.stream_idle_s}")
        if str(self.wal) not in ("on", "off"):
            raise ValueError(f"wal must be on|off, got {self.wal!r}")
        if int(self.wal_group_tokens) < 1:
            raise ValueError(f"wal_group_tokens must be >= 1, got "
                             f"{self.wal_group_tokens}")
        if float(self.wal_group_ms) < 0 or \
                float(self.state_snapshot_s) <= 0:
            raise ValueError("wal_group_ms must be >= 0 and "
                             "state_snapshot_s > 0")
        if float(self.session_ttl_s) < 0 or int(self.session_cap) < 0:
            raise ValueError("session_ttl_s/session_cap must be >= 0")
        if int(self.flush_tokens) < 1 or float(self.flush_ms) < 0:
            raise ValueError("flush_tokens must be >= 1 and flush_ms "
                             ">= 0")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "RouterSpec":
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
                if "str" in str(types[key]):
                    kw[key] = val.lower()
                else:
                    kw[key] = (float(val)
                               if "float" in str(types[key])
                               else int(val))
            except ValueError as e:
                raise ValueError(f"bad fleet spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


# signature cache for duck-typed handles: tests (and future adapters)
# plug in handles whose request() predates deadlines/priorities — the
# router forwards only the keywords each handle actually accepts
_SIG_CACHE: Dict[Any, Optional[frozenset]] = {}


def _accepted_kwargs(fn) -> Optional[frozenset]:
    key = getattr(fn, "__func__", fn)
    if key not in _SIG_CACHE:
        try:
            params = inspect.signature(key).parameters
            if any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
                _SIG_CACHE[key] = None       # **kwargs: takes anything
            else:
                _SIG_CACHE[key] = frozenset(params)
        except (TypeError, ValueError):
            _SIG_CACHE[key] = None
    return _SIG_CACHE[key]


def _handle_call(fn, args: tuple, kwargs: Dict[str, Any]):
    accepted = _accepted_kwargs(fn)
    if accepted is not None:
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    return fn(*args, **kwargs)


# -- engine handles ---------------------------------------------------------

class LocalEngineHandle:
    """In-process worker: a pinned `InferenceEngine` + `MicroBatcher`
    wrapped in an `InferenceServer` (no HTTP — the router IS the
    frontend).  `kill()`/`revive()` give tests and the bench a
    deterministic crash/recovery lever."""

    def __init__(self, name: str, server):
        self.name = name
        self.server = server          # serve.InferenceServer
        self.engine = server.engine
        self._alive = True

    def start(self) -> None:
        self.server.start()
        self._alive = True

    def stop(self) -> None:
        self._alive = False
        self.server.stop()

    def kill(self) -> None:
        """Simulate a worker crash: requests and probes fail until
        revive()."""
        self._alive = False
        self.server.stop()

    def revive(self) -> None:
        self.server.start()
        self._alive = True

    def probe(self) -> Dict[str, Any]:
        if not self._alive:
            raise EngineUnavailable(f"engine {self.name} is down")
        h = dict(self.engine.health())
        h["queue_depth"] = self.engine.stats.queue_depth
        return h

    def stats_snapshot(self) -> Dict[str, Any]:
        return self.server.snapshot()

    def request(self, mode: str, tokens,
                timeout: Optional[float] = None,
                deadline: Optional[float] = None,
                priority: str = "interactive",
                cancel_event: Optional[threading.Event] = None,
                tenant: str = "default") -> Dict[str, Any]:
        if not self._alive:
            raise EngineUnavailable(f"engine {self.name} is down")
        call = (self.server.generate if mode == "generate"
                else self.server.predict)
        try:
            return call(tokens, timeout=timeout, deadline=deadline,
                        priority=priority, cancel_event=cancel_event,
                        tenant=tenant)
        except (Overloaded, DeadlineExpired, TimeoutError, ValueError,
                Cancelled):
            raise
        except Exception as e:  # noqa: BLE001 — batch failed / stopped
            raise EngineUnavailable(
                f"engine {self.name} failed: {e}") from e

    def request_stream(self, tokens, timeout: Optional[float] = None,
                       max_new: Optional[int] = None,
                       deadline: Optional[float] = None,
                       priority: str = "interactive",
                       cancel_event: Optional[threading.Event] = None,
                       resume_from: int = 0,
                       tenant: str = "default"):
        """Streaming generate (cb engines only).  Admission happens
        HERE, before any event is yielded — the router's commit point
        for retry-on-other-engine.  Returns an iterator of ndjson-
        shaped dicts: {"token": t, "i": n} per token (n the absolute
        sequence number, resume_from-based for a failover
        re-admission), then the final {"done": True, ...} summary."""
        if not self._alive:
            raise EngineUnavailable(f"engine {self.name} is down")
        try:
            ticket = self.server.generate_stream(
                tokens, timeout=timeout, max_new=max_new,
                deadline=deadline, priority=priority,
                cancel_event=cancel_event, resume_from=resume_from,
                tenant=tenant)
        except (Overloaded, DeadlineExpired, TimeoutError, ValueError,
                Cancelled):
            raise
        except Exception as e:  # noqa: BLE001 — no cb / stopped
            raise EngineUnavailable(
                f"engine {self.name} cannot stream: {e}") from e
        budget = qos.transport_budget(
            deadline, timeout, self.engine.spec.request_timeout_s)

        def gen():
            # in-process hot path: drain the ticket in BATCHES (one
            # queue round-trip per flush_tokens instead of per token)
            # and stage them through a shared-memory TokenRing — raw
            # int32s end to end, nothing serialized, zero bytes
            # copied out of the ring's buffer (serve/wire.py).  The
            # first token drains alone: first-token latency is a
            # gated stage and must not pay for batching
            from . import wire as _wire
            spec = self.engine.spec
            flush_n = max(int(getattr(spec, "flush_tokens", 8)), 1)
            linger = max(float(getattr(spec, "flush_ms", 4.0)),
                         0.0) / 1000.0
            ring = _wire.TokenRing(max(flush_n * 8, 64))
            i = ticket.first_index
            first = True
            while True:
                evs = ticket.drain_events(
                    max_n=1 if first else flush_n,
                    timeout=budget,
                    linger_s=0.0 if first else linger)
                first = False
                toks = [p for k, p in evs if k == "tok"]
                if toks:
                    ring.push_many(toks)
                    left = len(toks)
                    while left > 0:
                        _k, _start, view = ring.peek_batch(left)
                        for t in view:
                            yield {"token": int(t), "i": i}
                            i += 1
                        ring.consume(len(view))
                        left -= len(view)
                    _wire.STATS.count("token_flushes")
                tail = evs[-1]
                if tail[0] == "tok":
                    continue
                if tail[0] == "failed":
                    raise tail[1]
                out = dict(tail[1])
                out["done"] = True
                yield out
                return
        return gen()

    def reload(self, step: Optional[int] = None) -> Dict[str, Any]:
        if not self._alive:
            raise EngineUnavailable(f"engine {self.name} is down")
        outcome = self.engine.reload_to(step)
        return {"outcome": outcome, "step": self.engine.params_step}


class HttpEngineHandle:
    """Worker behind a URL: a `singa_tpu_torch.main serve --pinned` process
    (membership from a hostfile).  Maps the server's status codes back
    to the router's exception vocabulary.

    Unary calls and probes ride a small keep-alive connection pool:
    opening a fresh TCP connection per request put connection setup on
    the hot path (and under probe cadence, several times a second per
    engine).  A pooled connection is returned after a clean
    keep-alive exchange and DISCARDED on any error — a socket that
    failed once is never trusted again.  Streams keep their own
    dedicated connections: a stream owns its socket for its lifetime,
    pooling it would just serialize streams behind each other."""

    #: pooled sockets per handle — enough for probe + a hedged pair
    POOL_CAP = 4

    def __init__(self, name: str, base_url: str,
                 connect_timeout_s: float = 5.0):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.connect_timeout_s = connect_timeout_s
        netloc = self.base_url.split("//", 1)[-1].split("/", 1)[0]
        host, _, port = netloc.partition(":")
        self._host, self._port = host or "127.0.0.1", int(port or 80)
        self._pool: deque = deque()
        self._pool_lock = threading.Lock()

    def _acquire_conn(self, timeout: float):
        """(connection, was_reused) — pop a pooled keep-alive socket
        or dial a fresh one."""
        with self._pool_lock:
            if self._pool:
                c = self._pool.popleft()
                if c.sock is not None:
                    c.sock.settimeout(timeout)
                return c, True
        c = http.client.HTTPConnection(self._host, self._port,
                                       timeout=timeout)
        return c, False

    def _release_conn(self, conn, reusable: bool) -> None:
        if reusable:
            with self._pool_lock:
                if len(self._pool) < self.POOL_CAP:
                    self._pool.append(conn)
                    return
        conn.close()

    def close(self) -> None:
        """Drop every pooled socket (fleet teardown)."""
        with self._pool_lock:
            conns, self._pool = list(self._pool), deque()
        for c in conns:
            c.close()

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None,
              timeout: Optional[float] = None,
              headers: Optional[Dict[str, str]] = None
              ) -> Dict[str, Any]:
        data = (json.dumps(payload).encode()
                if payload is not None else None)
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        budget = timeout or self.connect_timeout_s
        for attempt in (0, 1):
            conn, reused = self._acquire_conn(budget)
            try:
                conn.request(method, path, body=data, headers=hdrs)
                r = conn.getresponse()
                # drain the body BEFORE judging the status: an error
                # reply is a socket too, and under retry/hedge churn
                # leaving it to GC leaks one fd per failed call (the
                # fd-flat regression test in test_router_wal.py
                # watches this).  A fully-read keep-alive exchange —
                # success or mapped error — leaves the socket reusable
                body_bytes = r.read()
            except (http.client.HTTPException, ConnectionError,
                    OSError) as e:
                conn.close()
                if reused and attempt == 0:
                    # the stale keep-alive race: the peer closed this
                    # idle socket between our calls, nothing was
                    # processed — retry once on a FRESH connection
                    continue
                raise EngineUnavailable(
                    f"engine {self.name} unreachable: {e}") from e
            self._release_conn(conn, reusable=not r.will_close)
            body = {}
            try:
                body = json.loads(body_bytes)
            except Exception:  # noqa: BLE001 — non-JSON error body
                pass
            code = r.status
            if code == 200:
                return body
            if code == 503 and path == "/healthz":
                return body or {"ok": False, "status": "degraded"}
            if code == 503:
                raise Overloaded(
                    body.get("error", "overloaded"),
                    retry_after=float(body.get("retry_after", 0.0)))
            if code == 504:
                raise DeadlineExpired(body.get("error", "deadline"))
            if code == 400:
                raise ValueError(body.get("error", "bad request"))
            raise EngineUnavailable(
                f"engine {self.name}: HTTP {code} "
                f"{body.get('error', '')}")
        raise EngineUnavailable(f"engine {self.name} unreachable")

    def probe(self) -> Dict[str, Any]:
        h = self._call("GET", "/healthz")
        try:
            snap = self._call("GET", "/stats")
            h["queue_depth"] = snap.get("queue_depth", 0)
        except EngineUnavailable:
            h["queue_depth"] = 0
        return h

    def stats_snapshot(self) -> Dict[str, Any]:
        return self._call("GET", "/stats")

    @staticmethod
    def _qos_headers(deadline: Optional[float],
                     priority: Optional[str],
                     trace=None,
                     tenant: Optional[str] = None) -> Dict[str, str]:
        """End-to-end propagation over the wire: remaining-ms deadline
        header (re-anchored by the receiver), priority class, tenant
        id (`X-Tenant`), and the `X-Trace-Id`/`X-Parent-Span` pair —
        the worker's spans anchor under the router's attempt span in
        the merged trace."""
        hdrs: Dict[str, str] = {}
        dl = qos.deadline_to_header(deadline)
        if dl is not None:
            hdrs[qos.DEADLINE_HEADER] = dl
        if priority is not None:
            hdrs[qos.PRIORITY_HEADER] = str(priority)
        if tenant is not None:
            hdrs[qos.TENANT_HEADER] = str(tenant)
        hdrs.update(qos.trace_to_headers(trace))
        return hdrs

    def request(self, mode: str, tokens,
                timeout: Optional[float] = None,
                deadline: Optional[float] = None,
                priority: Optional[str] = None,
                trace=None,
                tenant: Optional[str] = None) -> Dict[str, Any]:
        toks = (tokens.tolist() if isinstance(tokens, np.ndarray)
                else list(tokens))
        payload = {"tokens": [int(t) for t in toks]}
        if timeout is not None:
            payload["timeout"] = timeout
        budget = qos.transport_budget(deadline, timeout,
                                      self.connect_timeout_s)
        return self._call("POST", f"/{mode}", payload, timeout=budget,
                          headers=self._qos_headers(deadline, priority,
                                                    trace, tenant))

    def request_stream(self, tokens, timeout: Optional[float] = None,
                       max_new: Optional[int] = None,
                       deadline: Optional[float] = None,
                       priority: Optional[str] = None,
                       resume_from: int = 0, trace=None,
                       tenant: Optional[str] = None):
        """Streaming generate over HTTP: POST {"stream": true} and
        decode the chunked ndjson line-by-line WITHOUT buffering the
        body.  The response status is the commit point: admission
        errors surface as mapped exceptions before any line is
        yielded; after that a transport failure is a mid-stream
        RuntimeError — which the router's session layer now catches
        and RESUMES on a sibling engine (`resume_from` carries the
        journaled-prefix length on a re-admission)."""
        toks = (tokens.tolist() if isinstance(tokens, np.ndarray)
                else list(tokens))
        payload: Dict[str, Any] = {"tokens": [int(t) for t in toks],
                                   "stream": True}
        if timeout is not None:
            payload["timeout"] = timeout
        if max_new is not None:
            payload["max_new"] = int(max_new)
        if int(resume_from) > 0:
            payload["resume_from"] = int(resume_from)
        budget = qos.transport_budget(deadline, timeout,
                                      self.connect_timeout_s)
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(self._qos_headers(deadline, priority, trace,
                                      tenant))
        req = urllib.request.Request(
            f"{self.base_url}/generate",
            data=json.dumps(payload).encode(), method="POST",
            headers=hdrs)
        try:
            resp = urllib.request.urlopen(req, timeout=budget)
        except urllib.error.HTTPError as e:
            # same fd discipline as _call: the error response is a
            # socket — close it before mapping the status
            body = {}
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001 — non-JSON error body
                pass
            finally:
                e.close()
            if e.code == 503:
                raise Overloaded(
                    body.get("error", "overloaded"),
                    retry_after=float(body.get("retry_after", 0.0)))
            if e.code == 504:
                raise DeadlineExpired(body.get("error", "deadline"))
            if e.code == 400:
                raise ValueError(body.get("error", "bad request"))
            raise EngineUnavailable(
                f"engine {self.name}: HTTP {e.code} "
                f"{body.get('error', '')}")
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise EngineUnavailable(
                f"engine {self.name} unreachable: {e}") from e

        def gen():
            try:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    if "error" in ev and "done" not in ev:
                        raise RuntimeError(
                            f"engine {self.name} stream failed: "
                            f"{ev['error']}")
                    yield ev
            except (urllib.error.URLError, ConnectionError,
                    OSError) as e:
                raise RuntimeError(
                    f"engine {self.name} stream broken: {e}") from e
            finally:
                # unconditional teardown: a hedge loser's gen.close()
                # or a failover abandon lands here via GeneratorExit,
                # and the socket dies WITH the generator — never
                # parked on the GC under churn
                resp.close()
        return gen()

    def reload(self, step: Optional[int] = None,
               trace=None) -> Dict[str, Any]:
        return self._call("POST", "/admin/reload", {"step": step},
                          timeout=60.0,
                          headers=qos.trace_to_headers(trace))


# -- router -----------------------------------------------------------------

@dataclass
class _Member:
    handle: Any
    healthy: bool = True          # last probe verdict (soft: re-enters
    step: int = -1                # on the next ok probe)
    family: str = "default"       # checkpoint family advertised on
                                  # /healthz: the fingerprint namespace
                                  # is (family, step)
    queue_depth: int = 0
    in_flight: int = 0
    strikes: int = 0              # consecutive probe/dispatch failures
    quarantined: bool = False
    quarantines: int = 0          # lifetime count (drives the Backoff)
    bench_until: float = 0.0      # monotonic readmission-probe time
    dispatched: int = 0
    failed: int = 0
    draining: bool = False        # retiring: no new admissions, pops
    last_health: Dict[str, Any] = field(default_factory=dict)  # when drained


class RouterStats:
    """Aggregate router counters (RouterStats ≈ the fleet-level
    ServeStats; per-engine detail lives in Router.members()).

    Beside the lifetime counters, `windowed()` reports rates over the
    last `window_s` seconds — the autoscaler's control inputs.  A
    cumulative shed counter can't distinguish "shed a lot at 9am" from
    "shedding right now"; the windowed view can."""

    FIELDS = ("routed", "completed", "retried", "failed", "shed",
              "quarantines", "readmissions", "joins", "retires",
              "attempts", "hedges", "hedge_wins", "deadline_terminal",
              "expired_on_arrival", "budget_denied", "brownout_sheds",
              "shed_interactive", "shed_batch", "shed_best_effort",
              "unknown_model", "lame_duck_refusals")

    #: per-request lifecycle stages the router can time (the stage
    #: taxonomy in docs/OBSERVABILITY.md); each gets its own
    #: `singa_request_stage_seconds_<stage>` histogram
    STAGES = ("admit", "dispatch", "first_token", "decode")

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self._latencies: List[float] = []
        self._t0 = time.monotonic()
        self._routed_t: deque = deque(maxlen=16384)   # (stamp, tenant)
        self._shed_t: deque = deque(maxlen=16384)     # (stamp, priority,
                                                      #  brownout, tenant)
        self._done_t: deque = deque(maxlen=16384)     # (stamp, latency,
                                                      #  priority, tenant)
        # (admitted at, engine, latency): a canary's own window
        self._engine_lat: deque = deque(maxlen=16384)
        # per-tenant lifetime accounting (bounded label set; callers
        # pass registry-FOLDED labels) — exported as singa_tenant_*
        self.tenants = TenantCounts(("routed", "completed", "shed"))
        # owned histogram handles, attached by register_into (None
        # without a registry — observe_latency/observe_stage stay
        # cheap no-ops on the histogram half)
        self._hist_latency = None
        self._stage_registry = None
        self._stage_hists: Dict[str, Any] = {}

    def count(self, fieldname: str, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            setattr(self, fieldname, getattr(self, fieldname) + n)
            if fieldname == "routed":
                self._routed_t.extend([(now, "default")] * n)
            elif fieldname == "shed":
                self._shed_t.extend(
                    [(now, "interactive", False, "default")] * n)

    def observe_routed(self, tenant: str = "default",
                       n: int = 1) -> None:
        """One admitted request, attributed to its tenant (the
        tenant-aware twin of `count("routed")`)."""
        now = time.monotonic()
        with self._lock:
            self.routed += n
            self._routed_t.extend([(now, tenant)] * n)
        self.tenants.count("routed", tenant, n)

    def observe_shed(self, priority: str = "interactive",
                     brownout: bool = False, n: int = 1,
                     tenant: str = "default") -> None:
        """One shed, attributed to its class and tenant.
        `brownout=False` is a CAPACITY shed (nothing could take the
        request) — the pressure signal that engages brownout; brownout
        sheds themselves are excluded from it, or shedding would keep
        brownout engaged forever (positive feedback)."""
        now = time.monotonic()
        with self._lock:
            self.shed += n
            setattr(self, f"shed_{priority}",
                    getattr(self, f"shed_{priority}") + n)
            if brownout:
                self.brownout_sheds += n
            self._shed_t.extend([(now, priority, brownout, tenant)] * n)
        self.tenants.count("shed", tenant, n)

    def observe_latency(self, seconds: float,
                        priority: str = "interactive",
                        tenant: str = "default",
                        engine: Optional[str] = None,
                        start: Optional[float] = None) -> None:
        """One completed request's latency; `engine` (the one that
        served it) and `start` (when the router admitted it) feed
        `engine_latency_quantile`."""
        now = time.monotonic()
        with self._lock:
            self._latencies.append(seconds)
            if len(self._latencies) > 4096:
                del self._latencies[:2048]
            self._done_t.append((now, seconds, priority, tenant))
            if engine is not None:
                self._engine_lat.append(
                    (now - seconds if start is None else start, engine,
                     seconds))
        self.tenants.count("completed", tenant)
        self.tenants.observe_latency(seconds, tenant)
        h = self._hist_latency
        if h is not None:
            h.observe(float(seconds))

    def observe_stage(self, stage: str, seconds: float) -> None:
        """One stage timing of a finished request.  Stage histograms
        are created lazily in the registry attached by register_into
        (no registry: no-op) — the stage partition shares the e2e
        clock and its boundary stamps, so per-request stages sum to
        the request's latency by construction."""
        reg = self._stage_registry
        if reg is None:
            return
        h = self._stage_hists.get(stage)
        if h is None:
            # idempotent: registry.histogram returns the same object
            # for the same name, so a lost race costs nothing
            h = reg.histogram(
                f"singa_request_stage_seconds_{stage}",
                f"per-request wall time in stage {stage!r}")
            self._stage_hists[stage] = h
        h.observe(float(seconds))

    def windowed(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Rates over the trailing window (capped at uptime so a
        young process isn't diluted toward zero)."""
        now = time.monotonic()
        with self._lock:
            window = float(window_s if window_s is not None
                           else self.window_s)
            window = min(window, max(now - self._t0, 1e-6))
            cut = now - window
            routed_rows = [tn for t, tn in self._routed_t if t >= cut]
            sheds = [(p, b, tn) for t, p, b, tn in self._shed_t
                     if t >= cut]
            done = [(l, p, tn) for t, l, p, tn in self._done_t
                    if t >= cut]
        routed = len(routed_rows)
        lats = sorted(l for l, _, _ in done)
        shed = len(sheds)
        capacity_shed = sum(1 for _, b, _ in sheds if not b)

        def q(frac, xs=None):
            xs = lats if xs is None else xs
            if not xs:
                return None
            return round(
                xs[min(int(frac * len(xs)), len(xs) - 1)] * 1e3, 3)
        shed_by_class = {p: 0 for p in qos.PRIORITIES}
        for p, _, _ in sheds:
            shed_by_class[p] = shed_by_class.get(p, 0) + 1
        completed_by_class = {p: 0 for p in qos.PRIORITIES}
        p95_by_class: Dict[str, Optional[float]] = {}
        for pri in qos.PRIORITIES:
            cls = sorted(l for l, p, _ in done if p == pri)
            completed_by_class[pri] = len(cls)
            p95_by_class[pri] = q(0.95, cls)
        # per-tenant window views: the autoscaler's quota-weighted
        # shed signal and the router's per-tenant brownout pressure
        tenant_labels = sorted(
            set(routed_rows)
            | {tn for _, _, tn in sheds}
            | {tn for _, _, tn in done})
        routed_by_tenant = {tn: 0 for tn in tenant_labels}
        for tn in routed_rows:
            routed_by_tenant[tn] += 1
        shed_by_tenant = {tn: 0 for tn in tenant_labels}
        capacity_shed_by_tenant = {tn: 0 for tn in tenant_labels}
        for _, b, tn in sheds:
            shed_by_tenant[tn] += 1
            if not b:
                capacity_shed_by_tenant[tn] += 1
        completed_by_tenant = {tn: 0 for tn in tenant_labels}
        p95_by_tenant: Dict[str, Optional[float]] = {}
        for tn in tenant_labels:
            tls = sorted(l for l, _, t2 in done if t2 == tn)
            completed_by_tenant[tn] = len(tls)
            p95_by_tenant[tn] = q(0.95, tls)
        capacity_shed_rate_by_tenant = {
            tn: round(capacity_shed_by_tenant[tn]
                      / max(routed_by_tenant.get(tn, 0), 1), 4)
            for tn in tenant_labels}
        return {
            "window_s": round(window, 3),
            "routed": routed,
            "shed": shed,
            "completed": len(lats),
            "qps": round(len(lats) / window, 3),
            "shed_rate": round(shed / max(routed, 1), 4),
            "capacity_shed_rate": round(
                capacity_shed / max(routed, 1), 4),
            "p50_latency_ms": q(0.5),
            "p95_latency_ms": q(0.95),
            "p99_latency_ms": q(0.99),
            "shed_by_class": shed_by_class,
            "completed_by_class": completed_by_class,
            "p95_by_class": p95_by_class,
            "routed_by_tenant": routed_by_tenant,
            "shed_by_tenant": shed_by_tenant,
            "completed_by_tenant": completed_by_tenant,
            "p95_by_tenant": p95_by_tenant,
            "capacity_shed_rate_by_tenant":
                capacity_shed_rate_by_tenant,
        }

    def latency_quantile(self, q: float) -> Optional[float]:
        with self._lock:
            lats = sorted(self._latencies)
        if not lats:
            return None
        return lats[min(int(q * len(lats)), len(lats) - 1)]

    def engine_latency_quantile(self, q: float, engine: str,
                                since: float) -> Optional[float]:
        """The q-quantile of the latencies of the requests `engine`
        served that the router admitted at or after `since` (None when
        there are none): a canary's own window."""
        with self._lock:
            lats = sorted(lat for t, e, lat in self._engine_lat
                          if e == engine and t >= since)
        if not lats:
            return None
        return lats[min(int(q * len(lats)), len(lats) - 1)]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
        p50, p95, p99 = (self.latency_quantile(0.5),
                         self.latency_quantile(0.95),
                         self.latency_quantile(0.99))
        out["p50_latency_ms"] = (round(p50 * 1e3, 3)
                                 if p50 is not None else None)
        out["p95_latency_ms"] = (round(p95 * 1e3, 3)
                                 if p95 is not None else None)
        out["p99_latency_ms"] = (round(p99 * 1e3, 3)
                                 if p99 is not None else None)
        win = self.windowed()
        out["qps_recent"] = win["qps"]
        out["shed_rate_recent"] = win["shed_rate"]
        out["p95_latency_recent_ms"] = win["p95_latency_ms"]
        out["p99_latency_recent_ms"] = win["p99_latency_ms"]
        out["by_tenant"] = self.tenants.snapshot()
        return out

    def register_into(self, registry,
                      prefix: str = "singa_fleet") -> None:
        from ..obs.metrics import Sample

        # owned histograms beside the scalar collectors: the quantile
        # gauges below are point estimates a scraper cannot aggregate
        # across routers; cumulative buckets + _sum/_count can be
        self._hist_latency = registry.histogram(
            f"{prefix}_request_latency_seconds",
            "end-to-end fleet request latency (seconds)")
        self._stage_registry = registry

        def collect():
            snap = self.snapshot()
            out = [Sample(f"{prefix}_{k}_total", "counter",
                          f"fleet router counter {k!r}",
                          float(snap[k])) for k in self.FIELDS]
            out += [Sample(f"{prefix}_{k}", "gauge",
                           f"fleet router gauge {k!r}", float(snap[k]))
                    for k in ("p50_latency_ms", "p95_latency_ms",
                              "p99_latency_ms", "qps_recent",
                              "shed_rate_recent",
                              "p95_latency_recent_ms",
                              "p99_latency_recent_ms")
                    if snap.get(k) is not None]
            return out

        registry.register_collector(collect)
        self.tenants.register_into(registry)


class RequestLog:
    """Per-request lifecycle records backing `GET /debug/requests`: a
    bounded last-N ring plus the slowest-N ever seen, each row
    carrying the corr/trace ids, the serving engine, per-stage
    timings, and the leg story (hedged / resumes) — the post-mortem
    index into the merged fleet trace (docs/OBSERVABILITY.md)."""

    def __init__(self, keep: int = 64, slowest: int = 16):
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=max(int(keep), 1))
        self._slowest: List[Dict[str, Any]] = []
        self._slowest_n = max(int(slowest), 1)
        self.recorded = 0

    def record(self, **rec) -> None:
        rec.setdefault("ts", round(time.time(), 6))
        with self._lock:
            self.recorded += 1
            self._recent.append(rec)
            self._slowest.append(rec)
            self._slowest.sort(
                key=lambda r: -(r.get("latency_ms") or 0.0))
            del self._slowest[self._slowest_n:]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"recorded": self.recorded,
                    "recent": list(self._recent),
                    "slowest": list(self._slowest)}


class Router:
    """See module docstring.  Thread-safe: frontend threads call
    `route`, one daemon thread runs `_probe_loop`, and the rollout
    controller reads `members()` / calls `handle_for`."""

    def __init__(self, handles: List[Any],
                 spec: Optional[RouterSpec] = None, log_fn=print,
                 tenancy: Optional[TenantRegistry] = None):
        if not handles:
            raise ValueError("Router needs at least one engine handle")
        names = [h.name for h in handles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate engine names: {names}")
        self.spec = spec or RouterSpec()
        self.log = log_fn
        self.stats = RouterStats()
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {
            h.name: _Member(handle=h) for h in handles}
        self._backoff = faults.Backoff(base=self.spec.readmit_base_s,
                                       cap=self.spec.readmit_cap_s,
                                       seed=self.spec.seed)
        # per-(tenant, class) shed Retry-After (the old single-class
        # backoff is the default tenant's interactive stream)
        self._shed_backoffs = qos.ClassBackoffs(base=0.05, cap=2.0,
                                                seed=self.spec.seed + 1)
        # global retry budget: retries AND hedges draw from it
        self.retry_budget = qos.RetryBudget(
            ratio=self.spec.retry_budget_ratio,
            burst=self.spec.retry_budget_burst)
        # per-tenant QoS envelopes: every retry/hedge/resume charges
        # the REQUESTING tenant's child budget (floor first, then the
        # shared bucket) — an unconfigured registry is all-default,
        # which degenerates to the pre-tenancy global arithmetic
        self.tenancy = tenancy or TenantRegistry()
        self.tenancy.bind_budgets(self.retry_budget)
        # durable stream sessions: the journal mid-stream failover
        # resumes from (serve/session.py)
        self.sessions = SessionManager()
        # crash-safe control plane (serve/sessionlog.py): the fleet
        # wires a SessionWal + epoch in via attach_wal before traffic;
        # epoch 0 = no durability (the in-memory-only shape)
        self.wal = None
        self.epoch = 0
        # lame-duck drain for zero-downtime handoff: non-None refuses
        # NEW admissions (LameDuck -> HTTP 409 + Retry-After at the
        # successor) while in-flight streams finish
        self.lame_duck: Optional[Dict[str, Any]] = None
        # per-request lifecycle records (GET /debug/requests)
        self.requests = RequestLog()
        # router-minted correlation ids for requests arriving without
        # one (an in-process caller outside any span)
        self._corr_ids = itertools.count(1)
        # cached control signals (recomputed at most every 0.5s: the
        # deques behind windowed() are too big for the hot path)
        self._hedge_cache: float = float(self.spec.hedge_max_s)
        self._hedge_cache_t: float = 0.0
        self._pressure: float = 0.0
        self._pressure_by_tenant: Dict[str, float] = {}
        self._pressure_t: float = 0.0
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Router":
        self.probe_all()              # first verdicts before traffic
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-probe", daemon=True)
        self._probe_thread.start()
        return self

    def stop(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(5.0)
            self._probe_thread = None

    # -- crash-safe control plane -------------------------------------------
    def attach_wal(self, wal, epoch: int) -> None:
        """Wire the durable session journal in (fleet does this
        BEFORE traffic): every open/token/resume/close is
        write-ahead journaled, and fresh sids are minted under
        `epoch` so a restarted router can never collide with a
        journaled predecessor's ids."""
        self.wal = wal
        self.epoch = int(epoch)
        self.sessions.configure(wal=wal, epoch=epoch,
                                ttl_s=self.spec.session_ttl_s,
                                cap=self.spec.session_cap)

    def enter_lame_duck(self, successor: Optional[str] = None,
                        retry_after: float = 0.5) -> None:
        self.lame_duck = {"successor": successor,
                          "retry_after": float(retry_after)}
        self.log(f"fleet: router entering lame-duck drain "
                 f"(successor: {successor or 'unannounced'})")

    def _check_lame_duck(self) -> None:
        ld = self.lame_duck
        if ld is None:
            return
        self.stats.count("lame_duck_refusals")
        raise LameDuck(
            "router is draining for handoff; new admissions go to "
            f"the successor ({ld['successor'] or 'see Retry-After'})",
            successor=ld["successor"], retry_after=ld["retry_after"])

    def export_control_state(self) -> Dict[str, Any]:
        """The slow-moving control state worth surviving a restart:
        quarantine strikes/benches (remaining seconds — monotonic
        stamps do not cross processes), and the per-(tenant, class)
        Retry-After streaks.  Rollout/autoscaler state merges in one
        level up (fleet.py owns those objects)."""
        now = time.monotonic()
        with self._lock:
            members = {n: {
                "strikes": m.strikes,
                "quarantined": m.quarantined,
                "quarantines": m.quarantines,
                "bench_remaining_s": round(
                    max(m.bench_until - now, 0.0), 4),
                "draining": m.draining,
            } for n, m in self._members.items()}
        return {"members": members,
                "shed_streaks": self._shed_backoffs.export_streaks()}

    def restore_control_state(self,
                              state: Optional[Dict[str, Any]]) -> None:
        """Re-apply a snapshot by engine NAME (runs after start()'s
        first probe round): a pre-crash quarantined engine stays
        benched for its REMAINING bench time — `_probe_one` skips
        benched members, so restart cannot launder a strike streak."""
        if not state:
            return
        now = time.monotonic()
        restored = []
        with self._lock:
            for n, rec in (state.get("members") or {}).items():
                m = self._members.get(n)
                if m is None:
                    continue          # membership changed: skip
                m.strikes = max(int(rec.get("strikes", 0)), m.strikes)
                m.quarantines = max(int(rec.get("quarantines", 0)),
                                    m.quarantines)
                if rec.get("quarantined"):
                    m.quarantined = True
                    m.healthy = False
                    m.bench_until = now + float(
                        rec.get("bench_remaining_s", 0.0))
                    restored.append(n)
        self._shed_backoffs.restore_streaks(
            state.get("shed_streaks") or {})
        if restored:
            self.log(f"fleet: restored quarantine benches for "
                     f"{restored} from control-state snapshot")

    def recover_sessions(self, reduced: Dict[str, Dict[str, Any]],
                         timeout: Optional[float] = None
                         ) -> Dict[str, int]:
        """Re-admit every journaled stream from a predecessor's WAL
        replay.  Finished streams re-register as replay-only terminal
        records (a no-op — no engine re-decodes them); live ones
        re-enter the existing `resume_from` path pinned to their
        journaled fingerprint and decode into the replay buffer a
        reconnecting client drains exactly-once."""
        out = {"terminal": 0, "recovered": 0, "failed": 0}
        for sid in sorted(reduced):
            rec = reduced[sid]
            try:
                if rec.get("terminal") is not None:
                    self.sessions.register_terminal(rec)
                    out["terminal"] += 1
                else:
                    self.recover_stream(rec, timeout=timeout)
                    out["recovered"] += 1
            except Exception as e:  # noqa: BLE001 — recovery is
                out["failed"] += 1  # per-stream best-effort
                self.log(f"fleet: recovery of stream {sid} failed: "
                         f"{type(e).__name__}: {e}")
        return out

    def recover_stream(self, rec: Dict[str, Any],
                       timeout: Optional[float] = None):
        """Re-admit ONE journaled live stream: open a session under
        the journaled sid with the journaled prefix (re-journaling
        both into THIS epoch's WAL, so it is self-contained), then
        drive the ordinary `_session_stream` consumer — entering via
        its recovery arm, which admits a resume leg pinned to the
        journaled fingerprint — into the session's replay buffer on a
        daemon thread.  The deadline is re-anchored fresh: the
        original died with the crash, and recovery owes the client
        its journaled tokens either way."""
        timeout = (float(timeout) if timeout is not None
                   else self.spec.request_timeout_s)
        deadline = qos.resolve_deadline(
            timeout, None, self.spec.request_timeout_s)
        priority = str(rec.get("priority") or "interactive")
        tenant = self.tenancy.label(rec.get("tenant"))
        session = self.sessions.open(
            prompt=np.asarray(rec.get("prompt") or [], np.int32),
            max_new=rec.get("max_new"), deadline=deadline,
            priority=priority, engine=rec.get("engine") or "",
            step=int(rec.get("step", -1)), tenant=tenant,
            family=rec.get("family"), sid=rec["sid"],
            emitted=rec.get("emitted"))
        session.attachable = True
        session.resumes = int(rec.get("resumes", 0))
        # seed the replay buffer with the journaled prefix: a client
        # that reconnects with resume_from=0 (lost everything) is owed
        # the WHOLE stream, not just the post-splice tail — attach()
        # drops indices below resume_from, so clients that kept their
        # prefix skip these for free
        for i, t in enumerate(session.emitted):
            session.replay_append({"token": int(t), "i": i,
                                   "sid": session.sid})
        self.stats.observe_routed(tenant)
        err = EngineUnavailable(
            f"router restarted under epoch {self.epoch}; "
            f"re-admitting journaled stream {session.sid}")
        gen = self._session_stream(session, None, time.monotonic(),
                                   priority, timeout, initial_err=err)

        def drive():
            try:
                for ev in gen:
                    session.replay_append(ev)
            except BaseException as e:  # noqa: BLE001 — honest
                session.replay_append({   # terminal for the client
                    "done": True, "finish": "failed",
                    "error": f"{type(e).__name__}: {e}",
                    "tokens": list(session.emitted),
                    "sid": session.sid, "step": session.step})
            finally:
                session.replay_finish()

        threading.Thread(target=drive,
                         name=f"recover-{session.sid}",
                         daemon=True).start()
        return session

    def attach_stream(self, sid: str, resume_from: int = 0):
        """Reconnect a client to a recovered (or replay-retained
        terminal) stream by `X-Session-Id`: yields the continuation
        from token index `resume_from` exactly-once.  Raises
        `UnknownSession` (HTTP 410) for an unjournaled/evicted sid,
        ValueError (400) for a live never-crashed stream — its
        original connection still owns it."""
        session = self.sessions.get(sid)
        if session is None:
            raise UnknownSession(
                f"unknown or expired session {sid!r}")
        if not session.attachable:
            raise ValueError(
                f"session {sid!r} is live on its original "
                f"connection and cannot be attached")
        self.sessions.stats.count("attached")
        return session.attach(resume_from=int(resume_from))

    # -- membership reads ---------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def handle_for(self, name: str):
        return self._members[name].handle

    def members(self) -> List[Dict[str, Any]]:
        """Point-in-time per-engine view (stats/rollout surface)."""
        with self._lock:
            return [{
                "name": n, "healthy": m.healthy,
                "quarantined": m.quarantined, "strikes": m.strikes,
                "step": m.step, "family": m.family,
                "in_flight": m.in_flight,
                "queue_depth": m.queue_depth,
                "dispatched": m.dispatched, "failed": m.failed,
                "quarantines": m.quarantines, "draining": m.draining,
            } for n, m in self._members.items()]

    def healthy_names(self) -> List[str]:
        with self._lock:
            return [n for n, m in self._members.items()
                    if m.healthy and not m.quarantined
                    and not m.draining]

    def engine_step(self, name: str) -> int:
        with self._lock:
            m = self._members.get(name)
            return m.step if m is not None else -1

    def engine_family(self, name: str) -> str:
        with self._lock:
            m = self._members.get(name)
            return m.family if m is not None else "default"

    def families(self) -> List[str]:
        """Every checkpoint family any member advertises (including
        unhealthy ones: a family mid-quarantine is still SERVED — a
        request for it sheds honestly rather than 404ing)."""
        with self._lock:
            return sorted({m.family for m in self._members.values()})

    # -- runtime membership (autoscaler surface) ----------------------------
    def add_engine(self, handle) -> None:
        """Admit a new worker at runtime.  The caller must hand over a
        STARTED, warmed handle — the first probe below is a verdict,
        not a warmup, and an unhealthy join simply stays out of
        dispatch until it probes ok."""
        with self._lock:
            if handle.name in self._members:
                raise ValueError(
                    f"duplicate engine name: {handle.name!r}")
            self._members[handle.name] = _Member(handle=handle)
        self._probe_one(handle.name)   # first verdict before traffic
        self.stats.count("joins")
        self.log(f"fleet: engine {handle.name} joined "
                 f"(step {self.engine_step(handle.name)})")
        obs.emit_event("fleet.join", engine=handle.name,
                       step=self.engine_step(handle.name))

    def remove_engine(self, name: str, drain: bool = True,
                      timeout_s: float = 30.0) -> bool:
        """Retire a worker.  `drain=True` stops admissions immediately
        (the member is excluded from `_pick` under the same lock that
        admits) and waits for in-flight work — including held stream
        slots — to finish before dropping the member; returns whether
        the drain completed inside `timeout_s`.  Retirement is
        deliberate, so the member record (strikes, quarantine history)
        leaves with it — a re-added engine starts clean."""
        with self._lock:
            m = self._members.get(name)
            if m is None:
                return True            # already gone
            m.draining = True          # no new picks from here on
        drained = True
        if drain:
            deadline = time.monotonic() + float(timeout_s)
            while True:
                with self._lock:
                    mm = self._members.get(name)
                    busy = mm is not None and mm.in_flight > 0
                if not busy:
                    break
                if time.monotonic() >= deadline:
                    drained = False
                    break
                time.sleep(0.005)
        if not drained:
            # the engine is leaving whether its streams finished or
            # not: fail every live session over to a sibling so
            # scale-down never truncates a journaled stream
            kicked = self.sessions.kick_engine(name, "drain timeout")
            if kicked:
                self.log(f"fleet: drain of {name} timed out with "
                         f"{kicked} live stream(s); failing them over")
        with self._lock:
            self._members.pop(name, None)
        self.stats.count("retires")
        self.log(f"fleet: engine {name} retired "
                 f"({'drained' if drained else 'drain timed out'})")
        obs.emit_event("fleet.retire", engine=name, drained=drained)
        return drained

    # -- probing ------------------------------------------------------------
    def _probe_loop(self) -> None:
        period = float(self.spec.probe_period_s)
        while not self._probe_stop.wait(period):
            self.probe_all()

    def probe_all(self) -> None:
        """One probe round over every member (also callable directly —
        tests and the rollout controller tighten timing with it)."""
        for name in self.names():
            self._probe_one(name)

    def _probe_one(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
        if m is None:
            return                    # retired while we iterated
        now = time.monotonic()
        if m.quarantined and now < m.bench_until:
            return                    # still benched; don't even probe
        try:
            with obs.span("router.probe", engine=name):
                h = m.handle.probe()
        except Exception as e:  # noqa: BLE001 — probe failure = strike
            self._strike(name, f"probe failed: {e}")
            return
        with self._lock:
            was_quarantined = m.quarantined
            m.last_health = h
            m.healthy = bool(h.get("ok"))
            m.step = int(h.get("step", -1))
            m.family = str(h.get("family", "default"))
            m.queue_depth = int(h.get("queue_depth", 0))
            if m.healthy:
                m.strikes = 0
                if was_quarantined:
                    m.quarantined = False
                    self.stats.count("readmissions")
        if m.healthy and was_quarantined:
            self.log(f"fleet: engine {name} readmitted after "
                     f"quarantine (probe ok, step {m.step})")
            obs.emit_event("fleet.readmit", engine=name, step=m.step)

    def _strike(self, name: str, why: str) -> None:
        """One probe/dispatch failure; `quarantine_after` consecutive
        strikes bench the engine for a Backoff delay that escalates
        with each consecutive quarantine (the ReplicaSet
        poisoned-round policy, serving-side).  A member retired
        mid-failure is not charged — its record is already gone."""
        with self._lock:
            m = self._members.get(name)
        if m is None:
            return
        with self._lock:
            m.strikes += 1
            m.healthy = False
            if m.strikes < self.spec.quarantine_after or m.quarantined:
                if m.quarantined:
                    # failed its readmission probe: bench it again,
                    # longer (the strike streak keeps growing)
                    m.quarantines += 1
                    m.bench_until = time.monotonic() + \
                        self._backoff.delay(m.quarantines - 1)
                return
            m.quarantined = True
            m.quarantines += 1
            delay = self._backoff.delay(m.quarantines - 1)
            m.bench_until = time.monotonic() + delay
            self.stats.count("quarantines")
        self.log(f"fleet: engine {name} quarantined for "
                 f"{delay:.2f}s ({why})")
        obs.emit_event("fleet.quarantine", engine=name, why=why,
                       bench_s=round(delay, 4))

    # -- dispatch -----------------------------------------------------------
    def _pick(self, exclude: set,
              family: Optional[str] = None) -> Optional[str]:
        """Least-loaded healthy engine (in-flight + probed queue
        depth), excluding already-tried ones; `family` restricts to
        members advertising that checkpoint family (model-aware
        dispatch — None routes anywhere, the legacy single-family
        shape)."""
        with self._lock:
            cands = [(m.in_flight + m.queue_depth, n)
                     for n, m in self._members.items()
                     if n not in exclude and m.healthy
                     and not m.quarantined and not m.draining
                     and (family is None or m.family == family)]
            if not cands:
                return None
            _, name = min(cands)
            self._members[name].in_flight += 1
            return name

    def _release(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.in_flight -= 1

    def _check_family(self, model: Optional[str]) -> Optional[str]:
        """Normalize the requested model family against what the fleet
        SERVES (any member, healthy or not: a family mid-quarantine
        sheds honestly later rather than 404ing).  None/blank routes
        anywhere — the legacy single-family shape.  An unserved family
        raises `UnknownModel` before any engine is picked: a fast 404,
        never a strike, never a Retry-After."""
        if model is None:
            return None
        family = str(model).strip().lower()
        if not family:
            return None
        with self._lock:
            served = {m.family for m in self._members.values()}
        if family not in served:
            self.stats.count("unknown_model")
            obs.emit_event("serve.unknown_model", family=family,
                           served=sorted(served))
            raise UnknownModel(
                f"no engine serves model family {family!r} "
                f"(served: {sorted(served)})")
        return family

    # -- hedging / brownout control signals ---------------------------------
    def _hedge_delay(self) -> float:
        """When to launch the hedge: the windowed p95 latency ("Tail
        at Scale" — hedge only the slowest ~5%), clamped to
        [hedge_min_s, hedge_max_s]; hedge_max_s while there is no
        latency history yet.  Cached ~0.5s."""
        now = time.monotonic()
        if now - self._hedge_cache_t < 0.5:
            return self._hedge_cache
        p95 = self.stats.windowed()["p95_latency_ms"]
        d = (float(self.spec.hedge_max_s) if p95 is None
             else p95 / 1e3)
        d = min(max(d, float(self.spec.hedge_min_s)),
                float(self.spec.hedge_max_s))
        self._hedge_cache, self._hedge_cache_t = d, now
        return d

    def _brownout_sheds(self, priority: str,
                        tenant: str = "default") -> bool:
        """Router-level brownout: when the recent CAPACITY-shed rate
        (sheds where nothing could take the request — brownout's own
        sheds excluded, see RouterStats.observe_shed) crosses
        `brownout_shed_rate`, stop admitting best_effort; at 3x the
        threshold, batch too.  Interactive always passes.  The
        pressure is the TENANT'S OWN capacity-shed rate: one tenant's
        overflow browning out its own background classes is the system
        working — it must never brown out a quiet neighbor's."""
        if priority == "interactive" or \
                float(self.spec.brownout_shed_rate) <= 0:
            return False
        now = time.monotonic()
        if now - self._pressure_t > 0.5:
            win = self.stats.windowed(5.0)
            self._pressure = float(win["capacity_shed_rate"])
            self._pressure_by_tenant = dict(
                win.get("capacity_shed_rate_by_tenant") or {})
            self._pressure_t = now
        pressure = float(self._pressure_by_tenant.get(tenant, 0.0))
        thr = float(self.spec.brownout_shed_rate)
        if priority == "best_effort":
            return pressure >= thr
        return pressure >= 3 * thr

    def _call_handle(self, name: str, mode: str, tokens,
                     timeout, deadline, priority,
                     cancel_event, trace=None,
                     tenant: str = "default") -> Dict[str, Any]:
        """One engine call, forwarding only the QoS keywords the
        handle's `request` signature accepts (duck-typed handles
        predate deadlines/priorities/trace context/tenancy)."""
        with self._lock:
            m = self._members.get(name)
        if m is None:
            raise EngineUnavailable(f"engine {name} retired "
                                    f"mid-dispatch")
        return _handle_call(
            m.handle.request, (mode, tokens),
            {"timeout": timeout, "deadline": deadline,
             "priority": priority, "cancel_event": cancel_event,
             "trace": trace, "tenant": tenant})

    def _try_hedge(self, exclude: set, cancels: Dict[str, Any],
                   launch, deadline, tenant: str = "default",
                   family: Optional[str] = None) -> Optional[str]:
        """Launch the hedged attempt if the budget, the fleet, and the
        deadline allow.  A `serve.hedge` fault abandons the hedge only
        — the primary is untouched.  Returns the hedge engine's name,
        or None (with the spent token refunded when no dispatch
        happened).  The hedge charges the REQUESTING tenant's budget
        and stays inside the request's checkpoint family."""
        rem = qos.remaining_s(deadline)
        if rem is not None and rem <= 0:
            return None               # a hedge would be dead on arrival
        budget = self.tenancy.budget(tenant)
        if not budget.spend():
            self.stats.count("budget_denied")
            return None               # degrade to single-shot, not shed
        name = self._pick(exclude, family=family)
        if name is None:
            budget.refund()
            return None
        try:
            faults.maybe_fault("serve.hedge")
        except faults.FaultError as e:
            self._release(name)
            budget.refund()
            obs.emit_event("serve.hedge_abandoned", engine=name,
                           why=str(e))
            return None
        self.stats.count("hedges")
        cancels[name] = threading.Event()
        launch(name, None)
        return name

    def _hedged_request(self, name: str, mode: str, tokens,
                        timeout, deadline, priority,
                        corr: Optional[str] = None, link=None,
                        info: Optional[dict] = None,
                        tenant: str = "default",
                        family: Optional[str] = None) -> tuple:
        """Dispatch to `name`, hedging onto a sibling once the
        p95-derived delay elapses without a result; first result wins
        and the loser is cancelled.  Owns releasing every in-flight
        slot it holds (the caller's `_pick` took `name`'s).  Returns
        (winner, out) or raises the decisive exception — the
        primary's, unless only the hedge answered.  `corr`/`link`
        tag every leg with the ORIGINATING request's ids (hedge run()
        threads have no thread-local parent — without the explicit
        anchor each leg minted a fresh chain and the hedge was
        invisible in any trace); `info` (when given) reports
        `hedged=True` back to the caller."""
        resq: "queue.Queue" = queue.Queue()
        cancels: Dict[str, threading.Event] = {name: threading.Event()}

        def run(engine_name: str, site: Optional[str]) -> None:
            self.stats.count("attempts")
            try:
                with obs.span("router.attempt", corr=corr,
                              trace=link[0] if link else None,
                              parent=link[1] if link else None,
                              engine=engine_name,
                              hedge=engine_name != name) as asp:
                    if site is not None:
                        faults.maybe_fault(site)
                    out = self._call_handle(
                        name=engine_name, mode=mode, tokens=tokens,
                        timeout=timeout, deadline=deadline,
                        priority=priority,
                        cancel_event=cancels[engine_name],
                        trace=((asp.trace, asp.span_id)
                               if asp.trace else None),
                        tenant=tenant)
                resq.put((engine_name, "ok", out))
            except (Overloaded, DeadlineExpired, TimeoutError,
                    ValueError, Cancelled) as e:
                resq.put((engine_name, "err", e))
            except BaseException as e:  # noqa: BLE001 — engine failure
                with self._lock:
                    mm = self._members.get(engine_name)
                    if mm is not None:
                        mm.failed += 1
                self._strike(engine_name, f"dispatch failed: {e}")
                resq.put((engine_name, "err", e))
            finally:
                self._release(engine_name)

        def launch(engine_name: str, site: Optional[str]) -> None:
            threading.Thread(
                target=run, args=(engine_name, site),
                name=f"route-{engine_name}", daemon=True).start()

        if self.spec.hedge != "on" or len(self._members) <= 1:
            # inline fast path: same code, no thread, no hedge
            run(name, "fleet.dispatch")
            ename, kind, payload = resq.get_nowait()
            if kind == "err":
                raise payload
            return ename, payload

        launch(name, "fleet.dispatch")
        pending = {name}
        hedge_name: Optional[str] = None
        tried_hedge = False
        excs: Dict[str, BaseException] = {}
        winner, out = None, None
        while pending:
            tmo = None if tried_hedge else self._hedge_delay()
            try:
                ename, kind, payload = resq.get(timeout=tmo)
            except queue.Empty:
                tried_hedge = True
                hedge_name = self._try_hedge(
                    set(cancels), cancels, launch, deadline,
                    tenant=tenant, family=family)
                if hedge_name is not None:
                    pending.add(hedge_name)
                    if info is not None:
                        info["hedged"] = True
                continue
            pending.discard(ename)
            if kind == "ok":
                winner, out = ename, payload
                break
            if not isinstance(payload, Cancelled):
                excs[ename] = payload
        if winner is not None:
            for n, ev in cancels.items():
                if n != winner:
                    ev.set()
            if winner == hedge_name:
                self.stats.count("hedge_wins")
            return winner, out
        # every launched attempt failed: the PRIMARY's outcome decides
        # the retry story (the hedge was opportunistic)
        exc = excs.get(name)
        if exc is None and excs:
            exc = next(iter(excs.values()))
        raise exc if exc is not None else EngineUnavailable(
            f"engine {name} vanished mid-dispatch")

    def route(self, mode: str, tokens,
              timeout: Optional[float] = None,
              deadline: Optional[float] = None,
              priority: str = "interactive",
              tenant: Optional[str] = None,
              model: Optional[str] = None) -> Dict[str, Any]:
        """Dispatch one request; retries engine failures on other
        engines (every retry and hedge charging the REQUESTING
        tenant's view of the retry budget, and never outliving
        `deadline`) and sheds (`Overloaded` + per-(tenant, class)
        Retry-After) only when no engine can take it.  `model`
        restricts dispatch to engines advertising that checkpoint
        family — an unserved family raises `UnknownModel` (the honest
        fast 404) before any engine is picked.  The result carries
        `engine`, the member that served it."""
        self._check_lame_duck()
        priority = qos.check_priority(priority)
        tenant = self.tenancy.label(tenant)
        family = self._check_family(model)
        if timeout is None:
            timeout = self.spec.request_timeout_s
        deadline = qos.resolve_deadline(timeout, deadline,
                                        self.spec.request_timeout_s)
        t0 = time.monotonic()
        rem = qos.remaining_s(deadline)
        if rem is not None and rem <= 0:
            # dead on arrival at the router: no engine ever sees it
            self.stats.count("expired_on_arrival")
            raise DeadlineExpired(
                f"dead on arrival at router: deadline passed "
                f"{-rem:.3f}s ago")
        if self._brownout_sheds(priority, tenant):
            self._shed(f"brownout sheds {priority}",
                       priority=priority, brownout=True,
                       tenant=tenant)
        self.stats.observe_routed(tenant)
        tbudget = self.tenancy.budget(tenant)
        tbudget.earn()                # the primary dispatch's earning
        budget = (self.spec.max_attempts
                  if self.spec.max_attempts > 0 else len(self._members))
        tried: set = set()
        saturated = 0
        budget_stopped = False
        last_exc: Optional[BaseException] = None
        # the request's root ids on the router side: inherit the
        # caller's corr (the fleet frontend's span) when dispatched
        # under one, else mint fleet-N — every downstream leg
        # (attempt, hedge, worker, resume) is tagged with them
        corr = obs.current_corr() or f"fleet-{next(self._corr_ids)}"
        hedged: Dict[str, Any] = {}
        with obs.span("router.dispatch", corr=corr, mode=mode,
                      priority=priority, tenant=tenant) as sp:
            link = (sp.trace, sp.span_id) if sp.trace else None
            t1 = time.monotonic()    # admission done; dispatch begins
            for attempt in range(budget):
                rem = qos.remaining_s(deadline)
                if rem is not None and rem <= 0:
                    # a retry must never outlive the client deadline
                    self.stats.count("deadline_terminal")
                    raise DeadlineExpired(
                        f"deadline exhausted after {attempt} "
                        f"attempt(s)")
                if attempt > 0 and not tbudget.spend():
                    self.stats.count("budget_denied")
                    budget_stopped = True
                    break             # single-shot: first outcome stands
                name = self._pick(tried, family=family)
                if name is None:
                    if attempt > 0:
                        tbudget.refund()
                    break
                tried.add(name)
                try:
                    winner, out = self._hedged_request(
                        name, mode, tokens, timeout, deadline,
                        priority, corr=corr, link=link, info=hedged,
                        tenant=tenant, family=family)
                except Overloaded as e:
                    # load, not failure: no strike, try a sibling
                    saturated += 1
                    last_exc = e
                    self.stats.count("retried")
                    continue
                except (DeadlineExpired, TimeoutError):
                    # the request's own deadline died inside the
                    # engine — not an engine failure, no strike, and
                    # retrying elsewhere would only blow it further
                    self.stats.count("deadline_terminal")
                    raise
                except ValueError:
                    self.stats.count("failed")
                    raise          # unservable request, not a failure
                except Exception as e:  # noqa: BLE001 — engine failure
                    # (strike already charged inside _hedged_request)
                    last_exc = e
                    self.stats.count("retried")
                    continue
                with self._lock:
                    m = self._members.get(winner)
                    if m is not None:
                        m.dispatched += 1
                self._shed_backoffs.reset(priority, tenant=tenant)
                self.stats.count("completed")
                t2 = time.monotonic()
                lat = t2 - t0
                self.stats.observe_latency(lat, priority,
                                           tenant=tenant, engine=winner,
                                           start=t0)
                # stage partition shares the e2e clock and its
                # boundary stamps: admit + dispatch == latency exactly
                self.stats.observe_stage("admit", t1 - t0)
                self.stats.observe_stage("dispatch", t2 - t1)
                out["engine"] = winner
                sp.set(engine=winner, attempts=attempt + 1)
                self.requests.record(
                    corr=corr, trace=sp.trace or None, mode=mode,
                    engine=winner, priority=priority, tenant=tenant,
                    outcome="ok",
                    latency_ms=round(lat * 1e3, 3),
                    hedged=bool(hedged), attempts=attempt + 1,
                    stages_ms={
                        "admit": round((t1 - t0) * 1e3, 3),
                        "dispatch": round((t2 - t1) * 1e3, 3)})
                if sp.trace:
                    o = obs.active()
                    p95 = (self.stats.latency_quantile(0.95)
                           if o is not None
                           and o.spec.sample == "tail" else None)
                    obs.sample_trace(sp.trace, lat, p95_s=p95,
                                     hedged=bool(hedged))
                return out
            if budget_stopped and last_exc is not None:
                # the retry budget ran dry: degrade to single-shot —
                # the first attempt's outcome stands, the request is
                # never shed BECAUSE of the budget
                if isinstance(last_exc, Overloaded):
                    self.stats.observe_shed(priority, tenant=tenant)
                    raise last_exc    # the engine's honest Retry-After
                self.stats.count("failed")
                raise EngineUnavailable(
                    f"dispatch failed, retry budget exhausted "
                    f"({len(tried)} engine(s) tried): {last_exc}"
                ) from last_exc
            # nothing left to try: the fleet is saturated or down
            why = ("fleet saturated" if saturated
                   else "no healthy engine available"
                   if not tried else
                   f"all {len(tried)} reachable engine(s) failed")
            self._shed(why, priority=priority, tenant=tenant)

    def _call_stream(self, name: str, tokens, timeout, max_new,
                     deadline, priority, cancel_event,
                     resume_from: int = 0, trace=None,
                     tenant: str = "default"):
        with self._lock:
            m = self._members.get(name)
        if m is None:
            raise EngineUnavailable(f"engine {name} retired "
                                    f"mid-dispatch")
        return _handle_call(
            m.handle.request_stream, (tokens,),
            {"timeout": timeout, "max_new": max_new,
             "deadline": deadline, "priority": priority,
             "cancel_event": cancel_event,
             "resume_from": resume_from, "trace": trace,
             "tenant": tenant})

    def _hedged_stream(self, name: str, tokens, timeout, max_new,
                       deadline, priority,
                       corr: Optional[str] = None, link=None,
                       info: Optional[dict] = None,
                       tenant: str = "default",
                       family: Optional[str] = None) -> tuple:
        """Streaming twin of `_hedged_request`: FIRST BYTE wins — each
        attempt admits its stream and pulls one event; whichever
        event lands first commits that engine, the loser's
        cancel_event tears its slot down mid-decode.  Returns
        (winner, first_event, generator, cancel_event) with the
        winner's in-flight slot STILL HELD (released by the session
        stream wrapper); the cancel_event is the failover path's
        lever for tearing down a stalled winner."""
        resq: "queue.Queue" = queue.Queue()
        sel = threading.Lock()
        state = {"done": False}
        cancels: Dict[str, threading.Event] = {name: threading.Event()}

        def run(engine_name: str, site: Optional[str]) -> None:
            self.stats.count("attempts")
            ev = cancels[engine_name]
            try:
                # the attempt span covers admission through the
                # first-byte commit, anchored under the stream's root
                # (run() threads have no thread-local parent); the
                # worker anchors under THIS span via the trace kwarg
                with obs.span("router.attempt", corr=corr,
                              trace=link[0] if link else None,
                              parent=link[1] if link else None,
                              engine=engine_name,
                              hedge=engine_name != name,
                              stream=True) as asp:
                    if site is not None:
                        faults.maybe_fault(site)
                    gen = self._call_stream(
                        engine_name, tokens, timeout, max_new,
                        deadline, priority, ev,
                        trace=((asp.trace, asp.span_id)
                               if asp.trace else None),
                        tenant=tenant)
                    first = next(gen)  # the first-byte commit
            except (Overloaded, DeadlineExpired, TimeoutError,
                    ValueError, Cancelled, StopIteration) as e:
                self._release(engine_name)
                resq.put((engine_name, "err", e))
                return
            except BaseException as e:  # noqa: BLE001 — engine failure
                self._release(engine_name)
                with self._lock:
                    mm = self._members.get(engine_name)
                    if mm is not None:
                        mm.failed += 1
                self._strike(engine_name,
                             f"stream dispatch failed: {e}")
                resq.put((engine_name, "err", e))
                return
            with sel:
                late = state["done"]
                if not late:
                    # success keeps its in-flight slot held for
                    # _wrap_stream — no release here
                    resq.put((engine_name, "ok", (first, gen)))
            if late:                   # a winner was already chosen
                gen.close()
                self._release(engine_name)

        def launch(engine_name: str, site: Optional[str]) -> None:
            threading.Thread(
                target=run, args=(engine_name, site),
                name=f"stream-{engine_name}", daemon=True).start()

        if self.spec.hedge != "on" or len(self._members) <= 1:
            run(name, "fleet.dispatch")
            ename, kind, payload = resq.get_nowait()
            if kind == "err":
                raise payload
            return ename, payload[0], payload[1], cancels[ename]

        launch(name, "fleet.dispatch")
        pending = {name}
        hedge_name: Optional[str] = None
        tried_hedge = False
        excs: Dict[str, BaseException] = {}
        winner = first = gen = None
        while pending:
            tmo = None if tried_hedge else self._hedge_delay()
            try:
                ename, kind, payload = resq.get(timeout=tmo)
            except queue.Empty:
                tried_hedge = True
                hedge_name = self._try_hedge(
                    set(cancels), cancels, launch, deadline,
                    tenant=tenant, family=family)
                if hedge_name is not None:
                    pending.add(hedge_name)
                    if info is not None:
                        info["hedged"] = True
                continue
            pending.discard(ename)
            if kind == "ok":
                winner, (first, gen) = ename, payload
                break
            if not isinstance(payload, Cancelled):
                excs[ename] = payload
        with sel:
            state["done"] = True
        # any "ok" result in the queue now is a loser that beat the
        # state flag: close it and give back its slot
        while True:
            try:
                ename, kind, payload = resq.get_nowait()
            except queue.Empty:
                break
            if kind == "ok":
                payload[1].close()
                self._release(ename)
        if winner is not None:
            for n, ev in cancels.items():
                if n != winner:
                    ev.set()
            if winner == hedge_name:
                self.stats.count("hedge_wins")
            return winner, first, gen, cancels[winner]
        exc = excs.get(name)
        if exc is None and excs:
            exc = next(iter(excs.values()))
        raise exc if exc is not None else EngineUnavailable(
            f"engine {name} vanished mid-dispatch")

    def route_stream(self, tokens, timeout: Optional[float] = None,
                     max_new: Optional[int] = None,
                     deadline: Optional[float] = None,
                     priority: str = "interactive",
                     tenant: Optional[str] = None,
                     model: Optional[str] = None):
        """Streaming dispatch: pick an engine exactly like `route`,
        but return its token-event iterator instead of a buffered
        result.  Retry-on-other-engine applies ONLY until the first
        byte (a hedge's losing stream is cancelled, never replayed) —
        after that a failure surfaces to the caller, because tokens
        may already be on the wire and a replay would duplicate them.
        The engine's in-flight slot is held until the consumer
        exhausts (or abandons) the stream."""
        self._check_lame_duck()
        priority = qos.check_priority(priority)
        tenant = self.tenancy.label(tenant)
        family = self._check_family(model)
        if timeout is None:
            timeout = self.spec.request_timeout_s
        deadline = qos.resolve_deadline(timeout, deadline,
                                        self.spec.request_timeout_s)
        t0 = time.monotonic()
        # stage-boundary stamps on the tracer's clock (perf_counter):
        # post-hoc stream-stage spans are recorded from these
        p0 = time.perf_counter()
        rem = qos.remaining_s(deadline)
        if rem is not None and rem <= 0:
            self.stats.count("expired_on_arrival")
            raise DeadlineExpired(
                f"dead on arrival at router: deadline passed "
                f"{-rem:.3f}s ago")
        if self._brownout_sheds(priority, tenant):
            self._shed(f"brownout sheds {priority}",
                       priority=priority, brownout=True,
                       tenant=tenant)
        self.stats.observe_routed(tenant)
        tbudget = self.tenancy.budget(tenant)
        tbudget.earn()
        budget = (self.spec.max_attempts
                  if self.spec.max_attempts > 0 else len(self._members))
        tried: set = set()
        saturated = 0
        budget_stopped = False
        last_exc: Optional[BaseException] = None
        corr = obs.current_corr() or f"fleet-{next(self._corr_ids)}"
        hedged: Dict[str, Any] = {}
        # the stream's root span covers ONLY admission through the
        # first-byte commit and closes before the generator is handed
        # out — a span must never stay open across generator yields
        # (the consumer's pull cadence is not ours).  Post-admission
        # stages are recorded post-hoc against `link` at terminal.
        with obs.span("router.stream", corr=corr, mode="generate",
                      priority=priority, tenant=tenant) as sp:
            link = (sp.trace, sp.span_id) if sp.trace else None
            pa = time.perf_counter()  # admission done; dispatch begins
            for attempt in range(budget):
                rem = qos.remaining_s(deadline)
                if rem is not None and rem <= 0:
                    self.stats.count("deadline_terminal")
                    raise DeadlineExpired(
                        f"deadline exhausted after {attempt} "
                        f"attempt(s)")
                if attempt > 0 and not tbudget.spend():
                    self.stats.count("budget_denied")
                    budget_stopped = True
                    break
                name = self._pick(tried, family=family)
                if name is None:
                    if attempt > 0:
                        tbudget.refund()
                    break
                tried.add(name)
                try:
                    winner, first, gen, cancel = self._hedged_stream(
                        name, tokens, timeout, max_new, deadline,
                        priority, corr=corr, link=link, info=hedged,
                        tenant=tenant, family=family)
                except Overloaded as e:
                    saturated += 1
                    last_exc = e
                    self.stats.count("retried")
                    continue
                except (DeadlineExpired, TimeoutError):
                    self.stats.count("deadline_terminal")
                    raise
                except ValueError:
                    self.stats.count("failed")
                    raise
                except Exception as e:  # noqa: BLE001 — engine failure
                    last_exc = e
                    self.stats.count("retried")
                    continue
                # committed to this engine: open the durable session —
                # the journal + leg pump that let the stream survive
                # the engine (docs/SERVING.md, "Mid-stream failover").
                # It carries the originating corr + trace link so a
                # failover leg admitted later lands in the SAME trace.
                session = self.sessions.open(
                    prompt=tokens, max_new=max_new, deadline=deadline,
                    priority=priority, engine=winner,
                    step=self.engine_step(winner), corr=corr,
                    trace=link, tenant=tenant,
                    family=self.engine_family(winner))
                leg = _StreamLeg(self, session, winner, gen, cancel,
                                 first=first)
                sp.set(engine=winner, attempts=attempt + 1)
                return self._session_stream(
                    session, leg, t0, priority, timeout,
                    p0=p0, pa=pa, p1=time.perf_counter(),
                    link=link, hedged=bool(hedged))
        if budget_stopped and last_exc is not None:
            if isinstance(last_exc, Overloaded):
                self.stats.observe_shed(priority, tenant=tenant)
                raise last_exc
            self.stats.count("failed")
            raise EngineUnavailable(
                f"stream dispatch failed, retry budget exhausted "
                f"({len(tried)} engine(s) tried): {last_exc}"
            ) from last_exc
        why = ("fleet saturated" if saturated
               else "no healthy engine available"
               if not tried else
               f"all {len(tried)} reachable engine(s) failed")
        self._shed(why, priority=priority, tenant=tenant)

    def _session_stream(self, session, leg, t0: float, priority: str,
                        timeout: Optional[float], p0=None, pa=None,
                        p1=None, link=None, hedged: bool = False,
                        initial_err=None):
        """Consumer loop of a durable stream: journals every token by
        absolute sequence number, dedupes the splice (each index
        reaches the client AT MOST once), arms the per-stream idle
        watchdog, and on any leg death — transport break, silent
        stall, sequence gap, drain-timeout kick — swaps in a resume
        leg from `_failover_leg`.  The client iterator only learns a
        leg died when resume itself is impossible.  `p0`/`pa`/`p1`
        are the admit / dispatch-start / first-byte stage stamps from
        route_stream (tracer clock); the terminal records the stream
        stages post-hoc against `link`."""
        sstats = self.sessions.stats
        wal = self.sessions.wal
        idle = float(self.spec.stream_idle_s)
        state = "failed"
        finished = False
        staged = False
        # the durable-session protocol: the FIRST event a client sees
        # carries the sid (X-Session-Id's value) + router epoch, so a
        # reconnect after a crash/handoff can attach to the journal
        sent_first = False

        def _finish(outcome: str) -> None:
            """Terminal bookkeeping, exactly once: post-hoc stream
            stage spans (admit/first_token/decode partition the e2e
            latency exactly — one clock, shared boundary stamps), the
            stage histograms, the /debug/requests record, and the
            tail-sampling verdict for this request's trace."""
            nonlocal staged
            if staged:
                return
            staged = True
            p3 = time.perf_counter()
            lat = (p3 - p0) if p0 is not None else 0.0
            stages: Dict[str, float] = {}
            if p0 is not None and pa is not None and p1 is not None:
                stages = {"admit": pa - p0,
                          "first_token": p1 - pa,
                          "decode": p3 - p1}
                for st, secs in stages.items():
                    self.stats.observe_stage(st, secs)
            o = obs.active()
            if o is not None and link and p1 is not None:
                tr, psid = link
                o.tracer.add_span(
                    "stream.first_token", pa, p1 - pa,
                    corr=session.corr, trace=tr, parent=psid,
                    engine=session.engine)
                o.tracer.add_span(
                    "stream.decode", p1, p3 - p1, corr=session.corr,
                    trace=tr, parent=psid, engine=session.engine,
                    tokens=len(session.emitted),
                    resumes=session.resumes)
            self.requests.record(
                corr=session.corr, trace=link[0] if link else None,
                mode="stream", engine=session.engine,
                priority=priority,
                tenant=getattr(session, "tenant", "default"),
                outcome=outcome,
                latency_ms=round(lat * 1e3, 3), hedged=hedged,
                resumes=session.resumes,
                tokens=len(session.emitted),
                stages_ms={k: round(v * 1e3, 3)
                           for k, v in stages.items()})
            if link:
                p95 = (self.stats.latency_quantile(0.95)
                       if o is not None
                       and o.spec.sample == "tail" else None)
                obs.sample_trace(
                    link[0], lat, p95_s=p95,
                    failed=outcome not in ("done", "spliced"),
                    hedged=hedged, resumed=session.resumes > 0)

        def terminal(ev):
            """Splice the terminal event: the FULL token list from
            the journal (a resumed leg's own `tokens` is only its
            suffix), marked `spliced` when any failover happened."""
            out = dict(ev)
            out["engine"] = session.engine
            out.setdefault("sid", session.sid)
            if self.epoch:
                out.setdefault("epoch", self.epoch)
            if session.emitted or "tokens" in out:
                out["tokens"] = list(session.emitted)
            if session.resumes:
                out["spliced"] = True
                out["resumes"] = session.resumes
                sstats.count("spliced")
                obs.emit_event("stream.spliced", sid=session.sid,
                               engine=session.engine,
                               resumes=session.resumes,
                               tokens=len(session.emitted))
            return out

        try:
            if leg is None:
                # recovery arm: a WAL-recovered stream enters with no
                # live leg — the crash WAS the leg's death, so admit
                # the resume leg through the ordinary failover path
                # (pinned fingerprint, resume_from = journaled-prefix
                # length); None means the journal was already complete
                leg = self._failover_leg(
                    session, None,
                    initial_err or EngineUnavailable(
                        f"recovered stream {session.sid} has no "
                        f"live leg"), timeout)
            while leg is not None:
                try:
                    entry = session.q.get(
                        timeout=idle if idle > 0 else None)
                except queue.Empty:
                    sstats.count("idle_timeouts")
                    leg = self._failover_leg(session, leg, TimeoutError(
                        f"stream idle > {idle:.3f}s on engine "
                        f"{session.engine} (silent stall)"), timeout)
                    if leg is None:
                        break
                    continue
                src, kind, payload = entry
                if src is None:           # drain-timeout kick
                    leg = self._failover_leg(
                        session, leg, EngineUnavailable(
                            f"engine {session.engine} retiring "
                            f"mid-stream: {payload}"), timeout)
                    if leg is None:
                        break
                    continue
                if src is not leg:
                    # a zombie leg woke up after failover: its tokens
                    # are already journaled (or being re-derived by
                    # the resume leg) and its control events describe
                    # a leg we abandoned — drop everything
                    if kind == "ev" and not payload.get("done"):
                        sstats.count("dup_tokens")
                    continue
                if kind in ("err", "end"):
                    err = (payload if kind == "err" else
                           EngineUnavailable(
                               f"engine {session.engine} stream ended "
                               f"without a terminal event"))
                    leg = self._failover_leg(session, leg, err,
                                             timeout)
                    if leg is None:
                        break
                    continue
                ev = payload
                if ev.get("done"):
                    state = "spliced" if session.resumes else "done"
                    finished = True
                    _finish(state)
                    yield terminal(ev)
                    return
                i = int(ev.get("i", session.next_i))
                if i < session.next_i:
                    sstats.count("dup_tokens")
                    continue
                if i > session.next_i:
                    sstats.count("gap_events")
                    leg = self._failover_leg(
                        session, leg, RuntimeError(
                            f"sequence gap on {session.engine}: "
                            f"expected index {session.next_i}, "
                            f"got {i}"), timeout)
                    if leg is None:
                        break
                    continue
                session.record(ev["token"])
                if wal is not None:
                    # write-ahead of delivery: the journal sees the
                    # token before the client does (group-committed
                    # off the critical path by the WAL's flusher)
                    wal.append_tok(session.sid, session.next_i - 1,
                                   int(ev["token"]))
                if not sent_first:
                    ev = dict(ev)
                    ev["sid"] = session.sid
                    if self.epoch:
                        ev["epoch"] = self.epoch
                    sent_first = True
                yield ev
            # _failover_leg returned None: the journal already holds
            # every token (the leg died between its last token and
            # its terminal event) — synthesize the done honestly
            state, finished = "spliced", True
            _finish(state)
            yield terminal({"done": True, "finish": "length",
                            "step": session.step})
        except _FailoverStale as e:
            # no same-fingerprint engine remains: an honest terminal
            # with the journaled prefix, never a cross-checkpoint lie
            state, finished = "failover_stale", True
            _finish(state)
            yield {"done": True, "finish": "failover_stale",
                   "engine": session.engine, "step": session.step,
                   "sid": session.sid,
                   "tokens": list(session.emitted),
                   "resumes": session.resumes, "error": str(e)}
        finally:
            _finish(state if finished else "failed")
            if leg is not None:
                (leg.release if finished else leg.abandon)()
            self.sessions.close(session, state)
            if finished:
                with self._lock:
                    m = self._members.get(session.engine)
                    if m is not None:
                        m.dispatched += 1
                tenant = getattr(session, "tenant", "default")
                self._shed_backoffs.reset(priority, tenant=tenant)
                self.stats.count("completed")
                self.stats.observe_latency(time.monotonic() - t0,
                                           priority, tenant=tenant,
                                           engine=session.engine,
                                           start=t0)
            else:
                self.stats.count("failed")

    def _failover_leg(self, session, old_leg, err, timeout):
        """Replace a dead stream leg: re-admit (prompt ‖ emitted
        prefix) as fresh prefill on a sibling pinned to the SAME
        checkpoint fingerprint, continuing from the next owed index —
        sound because greedy decode is bit-deterministic given
        (fingerprint, prompt, tokens-so-far).  Raises `_FailoverStale`
        when only other fingerprints remain, and otherwise degrades
        to `err` — the pre-failover terminal error — whenever resume
        is off, denied (budget/deadline), faulted (`serve.resume`),
        or inadmissible: failover can never turn a crash into a hang
        or a duplicate.  Returns the new leg, or None when the
        journal is already complete."""
        sstats = self.sessions.stats
        old_engine = session.engine
        if old_leg is not None:
            old_leg.abandon()
        sstats.count("failovers")
        session.resumes += 1
        session.state = "failed_over"
        with self._lock:
            m = self._members.get(old_engine)
            draining = m is None or m.draining
        if old_leg is not None and not draining:
            # a deliberate retirement is not the engine's fault; a
            # mid-stream death is.  Recovery (old_leg None) never
            # strikes: the ROUTER died, not the engine — and the
            # journaled engine is a fine resume candidate.
            self._strike(old_engine, f"stream leg failed: {err}")
        if self.spec.resume != "on":
            raise err
        rem = qos.remaining_s(session.deadline)
        if rem is not None and rem <= 0:
            sstats.count("resume_denied")
            self.stats.count("deadline_terminal")
            raise DeadlineExpired(
                f"stream leg died ({err}) with deadline already "
                f"exhausted") from err
        try:
            # one resume attempt per visit: an injected failure
            # abandons the resume and the stream degrades to the
            # pre-failover terminal error
            faults.maybe_fault("serve.resume")
        except Exception:  # noqa: BLE001 — injected fault
            sstats.count("resume_faults")
            raise err
        if session.max_new is not None and \
                session.next_i >= session.max_new:
            return None               # journal already complete
        # the resume charges the tenant that OWNS the stream: one
        # tenant's straggler storm of failovers drains its own floor
        # and the shared bucket, never a neighbor's floor
        tbudget = self.tenancy.budget(
            getattr(session, "tenant", "default"))
        tried = {old_engine} if old_leg is not None else set()
        while True:
            if not tbudget.spend():
                sstats.count("resume_denied")
                self.stats.count("budget_denied")
                raise err
            name, other_steps = self._pick_resume(
                tried, session.step,
                family=getattr(session, "family", None))
            if name is None:
                tbudget.refund()
                if other_steps:
                    raise _FailoverStale(
                        f"no engine pinned to fingerprint "
                        f"({getattr(session, 'family', 'default')}, "
                        f"{session.step}) remains (siblings serve a "
                        f"different fingerprint); refusing to splice "
                        f"across checkpoints") from err
                sstats.count("resume_denied")
                raise err
            tried.add(name)
            with self._lock:
                mem = self._members.get(name)
            if mem is not None:
                acc = _accepted_kwargs(mem.handle.request_stream)
                if acc is not None and "resume_from" not in acc:
                    # a handle that silently dropped resume_from
                    # would replay the stream from index 0 — degrade
                    # instead of splicing garbage
                    self._release(name)
                    tbudget.refund()
                    sstats.count("resume_denied")
                    raise err
            cancel = threading.Event()
            at = session.next_i
            try:
                self.stats.count("attempts")
                # the resume leg is anchored on the session's stored
                # trace link and tagged with the ORIGINATING corr —
                # this code runs on whatever thread the consumer loop
                # happens to own, seconds after the root span closed,
                # so only the explicit anchor keeps primary and
                # resumed legs in ONE trace (the old leg minted a
                # fresh chain and the splice was invisible)
                with obs.span(
                        "router.resume", corr=session.corr,
                        trace=(session.trace[0]
                               if session.trace else None),
                        parent=(session.trace[1]
                                if session.trace else None),
                        engine=name, from_engine=old_engine,
                        at=at) as rsp:
                    gen = self._call_stream(
                        name, session.resume_tokens(), timeout,
                        session.max_new, session.deadline,
                        session.priority, cancel, resume_from=at,
                        trace=((rsp.trace, rsp.span_id)
                               if rsp.trace else None),
                        tenant=getattr(session, "tenant", "default"))
                    first = next(gen)
            except Overloaded:
                self._release(name)
                continue              # saturated sibling: try another
            except ValueError as e:
                self._release(name)
                sstats.count("resume_denied")
                raise err from e      # inadmissible resume: degrade
            except DeadlineExpired as e:
                self._release(name)
                self.stats.count("deadline_terminal")
                raise e from err
            except StopIteration:
                self._release(name)
                continue
            except BaseException as e:  # noqa: BLE001 — engine died
                self._release(name)
                with self._lock:
                    mm = self._members.get(name)
                    if mm is not None:
                        mm.failed += 1
                self._strike(name, f"resume dispatch failed: {e}")
                continue
            session.engine = name
            sstats.count("resumed")
            if self.sessions.wal is not None:
                self.sessions.wal.append_resume(session.sid, name, at)
            obs.emit_event("stream.resume", sid=session.sid,
                           from_engine=old_engine, engine=name,
                           at=at, resumes=session.resumes,
                           why=str(err))
            self.log(f"fleet: stream {session.sid} resumed on "
                     f"{name} from token {at} ({err})")
            return _StreamLeg(self, session, name, gen, cancel,
                              first=first)

    def _pick_resume(self, exclude: set, step: int,
                     family: Optional[str] = None):
        """Least-loaded healthy engine pinned to the `(family, step)`
        fingerprint (in-flight slot taken), or (None, whether engines
        at OTHER fingerprints exist) — the caller's stale-vs-degrade
        decision.  `family=None` matches on step alone (legacy
        sessions)."""
        with self._lock:
            cands = []
            other_fps = False
            for n, m in self._members.items():
                if (n in exclude or not m.healthy or m.quarantined
                        or m.draining):
                    continue
                if int(m.step) != int(step) or (
                        family is not None and m.family != family):
                    other_fps = True
                    continue
                cands.append((m.in_flight + m.queue_depth, n))
            if not cands:
                return None, other_fps
            _, name = min(cands)
            self._members[name].in_flight += 1
            return name, other_fps

    def _shed(self, why: str, priority: str = "interactive",
              brownout: bool = False,
              tenant: str = "default") -> None:
        self.stats.observe_shed(priority, brownout=brownout,
                                tenant=tenant)
        retry = self._shed_backoffs.shed_delay(priority, tenant=tenant)
        # a shed is a terminal outcome: record it (corr/trace from
        # the enclosing dispatch span, when one is open) and keep its
        # trace — sheds are always interesting to the tail sampler
        tr = obs.trace_context()
        self.requests.record(
            corr=obs.current_corr(), trace=tr[0] if tr else None,
            priority=priority, tenant=tenant, outcome="shed", why=why)
        if tr:
            obs.sample_trace(tr[0], 0.0, shed=True)
        obs.emit_event("serve.shed", why=f"router: {why}",
                       priority=priority, tenant=tenant,
                       retry_after=round(retry, 4))
        raise Overloaded(f"request shed ({why}); retry after "
                         f"{retry:.3f}s", retry_after=retry)

    # -- rollout support ----------------------------------------------------
    def pick_canary(self, family: Optional[str] = None
                    ) -> Optional[str]:
        """The engine to canary a new checkpoint on: healthy and
        carrying the LEAST traffic — a bad fingerprint should touch as
        little of the fleet's load as possible.  `family` scopes the
        choice to one checkpoint family's members (per-family rollout
        canaries)."""
        with self._lock:
            cands = [(m.in_flight + m.queue_depth, n)
                     for n, m in self._members.items()
                     if m.healthy and not m.quarantined
                     and not m.draining
                     and (family is None or m.family == family)]
        return min(cands)[1] if cands else None

    def snapshot(self) -> Dict[str, Any]:
        out = self.stats.snapshot()
        out["engines"] = self.members()
        out["healthy_engines"] = len(self.healthy_names())
        out["streams"] = self.sessions.snapshot()
        out["families"] = self.families()
        out["by_tenant"] = self.stats.tenants.snapshot()
        out["tenancy"] = self.tenancy.snapshot()
        out["epoch"] = self.epoch
        out["lame_duck"] = self.lame_duck is not None
        return out


class _StreamLeg:
    """One engine-side transport attempt of a durable stream: a pump
    thread drains the handle's event iterator into the session's ONE
    queue tagged with this leg's identity, and the leg owns exactly
    one in-flight slot on its engine until `release()` (idempotent).
    `abandon()` is the failover teardown — cancel the engine-side
    decode, close the iterator, give back the slot; the pump may stay
    blocked inside the iterator (a zombie), but its late writes carry
    this leg's tag and the session consumer drops them."""

    def __init__(self, router, session, engine: str, gen, cancel,
                 first=None):
        self.router = router
        self.session = session
        self.engine = engine
        self.gen = gen
        self.cancel = cancel
        self._first = first
        self._released = False
        self._rel_lock = threading.Lock()
        threading.Thread(
            target=self._pump,
            name=f"leg-{session.sid}-{engine}", daemon=True).start()

    def _pump(self) -> None:
        q = self.session.q
        try:
            if self._first is not None:
                q.put((self, "ev", self._first))
            for ev in self.gen:
                q.put((self, "ev", ev))
            q.put((self, "end", None))
        except BaseException as e:  # noqa: BLE001 — leg death = event
            q.put((self, "err", e))

    def release(self) -> None:
        with self._rel_lock:
            if self._released:
                return
            self._released = True
        self.router._release(self.engine)

    def abandon(self) -> None:
        self.cancel.set()
        try:
            self.gen.close()
        except Exception:  # noqa: BLE001 — pump mid-next(): harmless
            pass
        self.release()
