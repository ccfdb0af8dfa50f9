"""Threaded serving frontend: stdlib HTTP plus an in-process client
API over the same engine + batcher.

The HTTP layer is deliberately thin — the transport never touches the
hot path ("RPC Considered Harmful"): a handler thread only parses
JSON, calls `MicroBatcher.submit` (or `ContinuousScheduler.submit`
under `cb=on`), and parks on the request's `Ticket` (or drains its
`StreamTicket`); all device work happens on the dispatch and scheduler
threads as replays of CUDA graphs that `start()` captured on the
caller's thread (generate AND predict by default, so no capture ever
runs on a serving thread), plus a reload's copy under the engine's
lock.

Port of `singa_tpu/serve/server.py:75-542`: the same start order,
routes, status mapping and supervised reload poll.  In-process callers
(`InferenceServer.generate` / `.predict`, used by tests and the bench
smoke) take the same submit/wait path, so both frontends share one
admission-control, batching, and stats story.

Endpoints:
    POST /generate  {"tokens": [ints], "timeout": s?}   -> {"tokens",
                    "step", "bucket", "latency_ms"}; under cb=on the
                    result carries "finish"/"slots" instead of
                    "bucket", and {"stream": true} switches the
                    response to chunked ndjson — one {"token": t}
                    line per decode step, then a terminal
                    {"done": true, "tokens", "finish", "step",
                    "latency_ms"} line (admission errors keep their
                    status codes; mid-stream failures become a
                    terminal {"error": ...} line)
    POST /predict   {"tokens": [ints], "timeout": s?}   -> {"logprobs",
                    "step", "bucket", "latency_ms"}
    GET  /stats     ServeStats.snapshot() incl. served params step
    GET  /metrics   Prometheus text exposition of the same counters
                    (each server owns a MetricsRegistry; the collector
                    reads ServeStats.snapshot(), so /metrics and /stats
                    agree by construction)
    GET  /healthz   engine.health(): 200 {"ok": true, ...} only while
                    the engine is actually healthy; 503 with
                    {"ok": false, "status": "degraded", "reasons"}
                    after `degraded_after` consecutive failed batches
                    or a refused/failed reload leaving stale params —
                    the signal the fleet router dispatches on
    GET  /trace     this process's span ring as a Perfetto dict
                    (obs.trace_dump(); empty when tracing is off) —
                    the buffer obs/collect.py pulls to merge fleet
                    traces into one timeline
    POST /admin/reload  {"step": n?} -> engine.reload_to(step): the
                    fleet rollout controller's command channel for
                    remote (subprocess) engine members; returns
                    {"outcome", "step"}
Status mapping: 503 + Retry-After on `Overloaded` (shed), 504 on
deadline/timeout, 400 on a malformed request, 500 on a failed batch.

A daemon poll thread calls `engine.poll_reload()` every
`spec.reload_poll_s` — hot reloads (and their counted degradations)
happen without any frontend involvement.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from .. import obs
from ..obs import perf
from ..obs.metrics import MetricsRegistry
from . import qos, wire
from .batcher import DeadlineExpired, MicroBatcher, Overloaded
from .engine import InferenceEngine, ServeSpec  # noqa: F401 (re-export)
from .scheduler import ContinuousScheduler, StreamTicket
from .stats import ServeStats  # noqa: F401 (re-export: stats mold)
from .tenancy import TenantRegistry


class InferenceServer:
    """Owns the engine, the batcher, the reload poll thread, and
    (optionally) the HTTP frontend.  `start()` loads + warms the
    engine and spins everything up; `stop()` tears it down in reverse
    order.  Usable as a context manager."""

    def __init__(self, engine: InferenceEngine,
                 host: str = "127.0.0.1", port: int = 0,
                 http: bool = True,
                 warmup_modes=("generate", "predict"),
                 log_fn=print,
                 tenancy: Optional[TenantRegistry] = None,
                 wire_on: bool = False, wire_port: int = 0):
        self.engine = engine
        self.stats = engine.stats
        # ONE tenant registry per server, shared by both admission
        # paths — quotas and brownout overrides agree by construction
        self.tenancy = tenancy if tenancy is not None \
            else TenantRegistry()
        self.batcher = MicroBatcher(engine, log_fn=log_fn,
                                    tenancy=self.tenancy)
        # cb=on: generate leaves the static buckets for the
        # continuous-batching scheduler (predict stays on the
        # batcher's bucket path)
        self.scheduler = (ContinuousScheduler(engine, log_fn=log_fn,
                                              tenancy=self.tenancy)
                          if engine.spec.cb_on else None)
        self.log = log_fn
        # per-server registry (not process-global: parallel tests each
        # get their own) backing the /metrics Prometheus endpoint
        self.metrics = MetricsRegistry()
        self.stats.register_into(self.metrics)
        # performance observatory (compiles/HBM/cost/readiness) + the
        # process-level collector (RSS/threads/fds/uptime) export on
        # every /metrics endpoint — a leaking engine must be visible
        perf.register_into(self.metrics)
        perf.register_process_into(self.metrics)
        # process-wide binary-transport counters (serve/wire.py) —
        # same process-global idiom as perf: every server's /metrics
        # shows the one wire story
        wire.register_into(self.metrics)
        self._host, self._port = host, port
        # binary framed listener beside the HTTP frontend; HTTP stays
        # the always-on debug-and-negotiation surface (/healthz
        # advertises the wire port)
        self._wire_wanted = bool(wire_on)
        self._wire_port = int(wire_port)
        self._wire: Optional[wire.BinaryTransportServer] = None
        self._http_wanted = http
        self._warmup_modes = tuple(warmup_modes)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self.engine.params is None or (
                self.engine.ckpt is not None
                and self.engine.params_step < 0):
            # no params yet, or constructor-fallback params with a
            # workspace that may hold something better: load() prefers
            # the latest healthy snapshot and keeps the fallback only
            # when nothing is restorable
            self.engine.load()
        n = self.engine.warmup(self._warmup_modes)
        shape = (f"cb slots={self.engine.spec.cb_slots} "
                 f"blocks={self.engine.spec.cb_pool_blocks}"
                 if self.engine.spec.cb_on
                 else f"buckets {self.engine.spec.buckets}")
        self.log(f"serve: warmed {n} program(s) for {shape}, serving "
                 f"checkpoint step {self.engine.params_step}")
        self.batcher.start()
        if self.scheduler is not None:
            self.scheduler.start()
        self._poll_stop.clear()
        if not self.engine.pinned:
            # pinned (fleet-member) engines never self-reload — the
            # rollout controller drives reload_to explicitly
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="serve-reload",
                daemon=True)
            self._poll_thread.start()
        if self._http_wanted:
            self._httpd = ThreadingHTTPServer(
                (self._host, self._port), _make_handler(self))
            self._httpd.daemon_threads = True
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="serve-http",
                daemon=True)
            self._http_thread.start()
            self.log(f"serve: http on {self.address[0]}:"
                     f"{self.address[1]}")
        if self._wire_wanted:
            self._wire = wire.BinaryTransportServer(
                self, host=self._host, port=self._wire_port,
                log_fn=self.log).start()
        return self

    def stop(self) -> None:
        if self._wire is not None:
            self._wire.stop()
            self._wire = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(5.0)
            self._poll_thread = None
        if self.scheduler is not None:
            self.scheduler.stop()
        self.batcher.stop()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def address(self):
        """(host, port) of the HTTP frontend (port resolved when the
        constructor asked for 0), or None without HTTP."""
        return self._httpd.server_address if self._httpd else None

    @property
    def wire_address(self):
        """(host, port) of the binary framed listener, or None when
        the server speaks HTTP only."""
        return self._wire.address if self._wire else None

    def _poll_loop(self) -> None:
        """Supervised reload poll: `poll_reload` already contains the
        expected degradations (failed reloads count + keep serving),
        but an UNEXPECTED exception here used to kill the daemon
        thread silently — the engine then served stale params forever
        behind a healthy /healthz.  Now a death is counted
        (`reload_poll_deaths`), the loop restarts itself after a
        Backoff delay, and `engine.health()` degrades once the death
        streak crosses `degraded_after` (the router stops dispatching
        to a poller that cannot stay alive)."""
        from ..utils import faults
        period = max(float(self.engine.spec.reload_poll_s), 0.01)
        backoff = faults.Backoff(base=period, cap=max(period * 16, 5.0),
                                 seed=0)
        while not self._poll_stop.wait(period):
            try:
                self.engine.poll_reload()
                self.engine.note_poll_ok()
            except Exception as e:  # noqa: BLE001 — supervised restart
                streak = self.engine.note_poll_death()
                self.stats.count("reload_poll_deaths")
                self.log(f"warning: reload poll died "
                         f"({type(e).__name__}: {e}); restarting "
                         f"(streak {streak})")
                if self._poll_stop.wait(backoff.delay(streak - 1)):
                    return

    # -- in-process client API ---------------------------------------------
    def generate(self, tokens, timeout: Optional[float] = None,
                 max_new: Optional[int] = None,
                 deadline: Optional[float] = None,
                 priority: str = "interactive",
                 tenant: Optional[str] = None,
                 cancel_event: Optional[threading.Event] = None
                 ) -> Dict[str, Any]:
        """Submit one prompt and block for the decoded continuation.
        Raises Overloaded / DeadlineExpired / TimeoutError exactly as
        the HTTP layer maps them.  `max_new` caps this request's
        generation under cb; the static bucket path decodes the full
        spec.max_new_tokens regardless (the whole batch shares one
        captured program) and only trims the reply.  `deadline`
        (absolute monotonic) is the request's end-to-end budget and
        wins over `timeout`; `priority` / `cancel_event` flow to
        admission (serve/qos.py)."""
        t0 = time.monotonic()
        if self.scheduler is not None:
            ticket = self.scheduler.submit(
                tokens, timeout=timeout, max_new=max_new,
                deadline=deadline, priority=priority, tenant=tenant,
                cancel_event=cancel_event)
        else:
            ticket = self.batcher.submit(
                tokens, mode="generate", timeout=timeout,
                deadline=deadline, priority=priority, tenant=tenant,
                cancel_event=cancel_event)
        out = ticket.wait(self._wait_budget(timeout, deadline))
        if self.scheduler is None and max_new is not None \
                and int(max_new) >= 1:
            out["tokens"] = out["tokens"][:int(max_new)]
        out["latency_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        return out

    def generate_stream(self, tokens,
                        timeout: Optional[float] = None,
                        max_new: Optional[int] = None,
                        deadline: Optional[float] = None,
                        priority: str = "interactive",
                        tenant: Optional[str] = None,
                        cancel_event: Optional[threading.Event] = None,
                        resume_from: int = 0) -> StreamTicket:
        """Streaming admission (cb only): returns the request's
        `StreamTicket` — iterate `.tokens()` / `.events()` for tokens
        as slots produce them.  `resume_from=n` re-admits a failover
        continuation: the last n prompt tokens are an already-emitted
        prefix, the ticket numbers its output from n.  Raises
        RuntimeError when the server is not running continuous
        batching."""
        if self.scheduler is None:
            raise RuntimeError("streaming generate needs cb=on in the "
                               "serve spec")
        return self.scheduler.submit(
            tokens, timeout=timeout, max_new=max_new,
            deadline=deadline, priority=priority, tenant=tenant,
            cancel_event=cancel_event, resume_from=resume_from)

    def predict(self, tokens,
                timeout: Optional[float] = None,
                deadline: Optional[float] = None,
                priority: str = "interactive",
                tenant: Optional[str] = None,
                cancel_event: Optional[threading.Event] = None
                ) -> Dict[str, Any]:
        """Next-token log-probs for one prompt (LM scoring)."""
        t0 = time.monotonic()
        ticket = self.batcher.submit(
            tokens, mode="predict", timeout=timeout,
            deadline=deadline, priority=priority, tenant=tenant,
            cancel_event=cancel_event)
        out = ticket.wait(self._wait_budget(timeout, deadline))
        out["latency_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        return out

    def _wait_budget(self, timeout: Optional[float],
                     deadline: Optional[float] = None) -> float:
        # queue deadline + dispatch slack: wait() must outlive the
        # in-queue deadline so expiry surfaces as DeadlineExpired, not
        # a bare TimeoutError.  qos.transport_budget clamps the slack
        # to the remaining deadline so the wait can't outlive the
        # client's budget by a flat 30s.
        return qos.transport_budget(
            deadline, timeout, self.engine.spec.request_timeout_s)

    def snapshot(self) -> Dict[str, Any]:
        out = self.stats.snapshot()
        out["params_step"] = self.engine.params_step
        if self.scheduler is not None:
            out["cb"] = self.scheduler.snapshot()
        return out


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: stats, not stdout
            pass

        def _reply(self, code: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str,
                        ctype: str = "text/plain; version=0.0.4; "
                                     "charset=utf-8") -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                self._reply(200, server.snapshot())
            elif self.path == "/metrics":
                self._reply_text(200, server.metrics.render_prometheus())
            elif self.path == "/healthz":
                h = server.engine.health()
                # transport negotiation: a healthy worker advertises
                # its binary listener here; clients that never look
                # stay on HTTP (the always-on debug surface)
                wa = server.wire_address
                if wa is not None:
                    h["wire_port"] = wa[1]
                self._reply(200 if h["ok"] else 503, h)
            elif self.path == "/trace":
                # this worker's span ring (Perfetto dict, carrying
                # wall_origin_s + process tags) — what obs/collect.py
                # pulls to merge the fleet's buffers into one timeline
                self._reply(200, obs.trace_dump())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def _remote_trace(self):
            """The caller's trace context from the header pair, or
            None — the anchor that makes this process's spans children
            of the router's dispatch span after the merge."""
            return qos.trace_from_headers(
                self.headers.get(qos.TRACE_HEADER),
                self.headers.get(qos.PARENT_SPAN_HEADER))

        def do_POST(self):
            mode = self.path.lstrip("/")
            # trace context rides every POST: the span this handler
            # opens is anchored under the caller's parent span id, so
            # the merged fleet trace shows router dispatch -> worker
            # admission as one tree (qos.trace_from_headers never
            # rejects a request over a malformed telemetry header)
            link = self._remote_trace()
            tr = link[0] if link else None
            psid = (link[1] or None) if link else None
            if self.path == "/admin/reload":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    step = req.get("step")
                    with obs.span("serve.reload", trace=tr,
                                  parent=psid, step=step):
                        outcome = server.engine.reload_to(
                            None if step is None else int(step))
                    self._reply(200, {
                        "outcome": outcome,
                        "step": server.engine.params_step})
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                return
            if mode not in ("generate", "predict"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                tokens = np.asarray(req["tokens"], np.int32)
                timeout = req.get("timeout")
                # end-to-end deadline: remaining-ms header re-anchored
                # onto THIS process's monotonic clock (serve/qos.py)
                deadline = qos.deadline_from_header(
                    self.headers.get(qos.DEADLINE_HEADER))
                priority = qos.check_priority(
                    req.get("priority")
                    or self.headers.get(qos.PRIORITY_HEADER))
                # degrade-never-reject: a missing/garbled tenant id
                # folds to "default" (check_tenant cannot raise)
                tenant = qos.check_tenant(
                    req.get("tenant")
                    or self.headers.get(qos.TENANT_HEADER))
                with obs.span("serve.request", trace=tr, parent=psid,
                              mode=mode, priority=priority,
                              tenant=tenant):
                    if mode == "generate":
                        max_new = req.get("max_new")
                        if max_new is not None:
                            max_new = int(max_new)
                        if req.get("stream") and \
                                server.scheduler is not None:
                            self._stream_generate(
                                tokens, timeout, max_new, deadline,
                                priority, tenant=tenant,
                                resume_from=int(
                                    req.get("resume_from", 0)))
                            return
                        out = server.generate(tokens, timeout=timeout,
                                              max_new=max_new,
                                              deadline=deadline,
                                              priority=priority,
                                              tenant=tenant)
                    else:
                        out = server.predict(tokens, timeout=timeout,
                                             deadline=deadline,
                                             priority=priority,
                                             tenant=tenant)
                self._reply(200, out)
            except Overloaded as e:
                self._reply(503, {"error": str(e),
                                  "retry_after": e.retry_after},
                            {"Retry-After": f"{e.retry_after:.3f}"})
            except (DeadlineExpired, TimeoutError) as e:
                self._reply(504, {"error": str(e)})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:  # noqa: BLE001 — failed batch etc.
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode()
                             + data + b"\r\n")

        def _stream_generate(self, tokens, timeout, max_new,
                             deadline=None, priority="interactive",
                             tenant=None, resume_from=0) -> None:
            """Chunked-transfer ndjson: one {"token": t, "i": n} line
            per produced token as the slot produces it (n the absolute
            sequence number — resume_from-based for a failover
            re-admission; old clients simply ignore the extra key),
            then a final {"done": true, ...} summary line.  Admission
            errors — including an inadmissible resume_from — raise
            BEFORE any byte is sent and take the normal status-code
            path in do_POST; a mid-stream failure becomes a terminal
            {"error": ...} line (the 200 is already on the wire).

            Lines are flushed in batches under the spec's
            flush_tokens/flush_ms knobs (one chunked write carrying
            several ndjson lines) — except the FIRST token of the
            stream, which always flushes alone so first-token latency
            never pays for batching."""
            t0 = time.monotonic()
            ticket = server.scheduler.submit(tokens, timeout=timeout,
                                             max_new=max_new,
                                             deadline=deadline,
                                             priority=priority,
                                             tenant=tenant,
                                             resume_from=resume_from)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            spec = server.engine.spec
            co = wire.LineCoalescer(
                self._chunk,
                flush_tokens=getattr(spec, "flush_tokens", 8),
                flush_ms=getattr(spec, "flush_ms", 4.0))
            i = ticket.first_index
            budget = server._wait_budget(timeout, deadline)
            first = True
            try:
                done = False
                while not done:
                    evs = ticket.drain_events(
                        max_n=1 if first else co.flush_tokens,
                        timeout=budget,
                        linger_s=0.0 if first else co.flush_s)
                    first = False
                    for kind, payload in evs:
                        if kind == "tok":
                            line = {"token": payload, "i": i}
                            i += 1
                            co.add(wire.timed_json_dumps(line)
                                   + b"\n")
                        elif kind == "failed":
                            # tokens drained before the failure are
                            # already queued; flush them, then the
                            # error line below
                            raise payload
                        else:
                            line = dict(payload)
                            line["done"] = True
                            line["latency_ms"] = round(
                                (time.monotonic() - t0) * 1e3, 3)
                            co.add(wire.timed_json_dumps(line)
                                   + b"\n", urgent=True)
                            done = True
            except Exception as e:  # noqa: BLE001 — mid-stream failure
                co.add(json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n", urgent=True)
            self._chunk(b"")      # terminal 0-length chunk

    return Handler
