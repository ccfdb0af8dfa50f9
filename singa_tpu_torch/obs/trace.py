"""Span tracer: thread-safe, ~zero-cost-when-off context-manager
spans exporting Chrome trace-event JSON.

Design targets (docs/OBSERVABILITY.md):

  * **~zero cost off** — instrumented code calls `obs.span(name)`,
    which is one module-global read plus returning a shared null
    context manager when no observability session is active (the same
    discipline as `faults.maybe_fault`).
  * **parenting** — each thread keeps a span stack; a new span's
    parent is the innermost open span on the SAME thread, recorded as
    `args.parent_id`.  Remote and cross-thread parents are explicit:
    `span(name, trace=..., parent=...)` anchors a span under a parent
    from another process (the `X-Trace-Id`/`X-Parent-Span` header
    pair) or another thread (a captured `context()` tuple).
  * **trace ids** — every root span mints a trace id; children (and
    explicitly-anchored remote spans) inherit it, so one request's
    spans across router threads, hedge legs, and worker processes all
    carry the same `args.trace` and a merged file groups by it.
  * **correlation ids** — a span either carries an explicit `corr`
    (e.g. `req-3`, `batch-7`, `attempt-2`) or inherits its parent's.
    Cross-thread flows (DeviceFeeder staging, HTTP handler → dispatch
    thread) pass the corr value explicitly; `current_corr()` reads the
    innermost corr on the calling thread for exactly that hand-off.
  * **telemetry never kills work** — recording a finished span
    consults the `obs.emit` fault site and swallows *any* failure into
    a `dropped` counter; the traced code path sees nothing.

Export format: `{"traceEvents": [...], "displayTimeUnit": "ms"}` with
`ph: "X"` complete events (ts/dur in microseconds) plus `ph: "M"`
thread-name and process-name metadata — the same trace-event schema
`utils/profiler.parse_trace_ops` consumes from device traces, so both
files load side by side in Perfetto / chrome://tracing.  The dict
additionally carries `process`, `pid`, and `wall_origin_s` top-level
keys (legal extras in the Chrome schema): `wall_origin_s` is the
wall-clock instant of this tracer's ts=0, which is what lets
`obs/collect.py` re-anchor buffers from different processes onto one
merged timeline.  (`utils/profiler.trace` writes the device traces, as
torch.profiler's Chrome export; `obs/collect.py` is the JAX package's
alone, ROADMAP.md A11.)

The port's own copy of `singa_tpu/obs/trace.py`, which is JAX-free
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils import faults


class SpanHandle:
    """The object a `with obs.span(...) as sp` body sees: carries the
    resolved trace/correlation ids and lets the body attach attributes
    that end up in the exported event's `args`."""

    __slots__ = ("name", "span_id", "parent_id", "trace", "corr",
                 "attrs", "_t0")

    def __init__(self, name: str, span_id: int, parent_id: int,
                 trace: str, corr: Optional[str],
                 attrs: Dict[str, Any], t0: float):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace = trace
        self.corr = corr
        self.attrs = attrs
        self._t0 = t0

    def set(self, **kw) -> None:
        self.attrs.update(kw)


class _NullHandle:
    """Shared no-op handle when tracing is off."""
    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = 0
    trace = ""
    corr = None

    def set(self, **kw) -> None:
        pass


NULL_HANDLE = _NullHandle()


class NullSpan:
    """Shared no-op context manager: the entire off-path cost of an
    instrumented site is one global read plus entering this."""
    __slots__ = ()

    def __enter__(self) -> _NullHandle:
        return NULL_HANDLE

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = NullSpan()


class _SpanCtx:
    """One live span.  Class-based (not @contextmanager) to keep the
    on-path overhead at a couple of attribute stores; exceptions in
    the body propagate untouched — the span still records."""

    __slots__ = ("_tracer", "_handle")

    def __init__(self, tracer: "Tracer", handle: SpanHandle):
        self._tracer = tracer
        self._handle = handle

    def __enter__(self) -> SpanHandle:
        self._tracer._push(self._handle)
        return self._handle

    def __exit__(self, exc_type, exc, tb) -> bool:
        h = self._handle
        dur = time.perf_counter() - h._t0
        self._tracer._pop()
        if exc_type is not None:
            h.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(h, dur)
        return False


class Tracer:
    """Thread-safe span recorder; see module docstring.

    `max_spans` bounds the in-memory buffer — spans past it are
    dropped (counted), never an error.  `ring > 0` switches the
    buffer to a ring of the most RECENT `ring` spans instead (older
    spans are evicted, counted in `evicted`) — the `GET /trace`
    serving mode, where a long-lived worker must always hold its
    freshest window.  `export(path)` writes the Chrome trace JSON;
    `events()` returns the raw event dicts for tests and in-process
    consumers."""

    def __init__(self, max_spans: int = 200_000, ring: int = 0,
                 process: Optional[str] = None):
        self.max_spans = max(int(max_spans), 1)
        self.ring = max(int(ring), 0)
        self.process = process or f"pid-{os.getpid()}"
        self.dropped = 0
        self.evicted = 0
        self.sampled_out = 0
        self._lock = threading.Lock()
        self._events: Any = (deque(maxlen=self.ring) if self.ring
                             else [])
        # span ids must stay unique across PROCESSES for a merged
        # parent_id graph to resolve, so each tracer counts from a
        # random 52-bit-safe base rather than 1
        self._ids = itertools.count(
            (int.from_bytes(os.urandom(4), "big") << 20) + 1)
        # trace ids: one random base per tracer plus a counter — a
        # root span mint is a dict-free string format, not a syscall
        self._trace_base = os.urandom(6).hex()
        self._trace_ids = itertools.count(1)
        self._local = threading.local()
        self._threads_seen: Dict[int, str] = {}
        # perf_counter origin for this tracer: ts values are relative
        # microseconds.  The paired wall-clock instant is what lets a
        # collector line this buffer up against other processes'.
        self._origin = time.perf_counter()
        self._wall_origin = time.time()

    def set_process(self, name: str) -> None:
        """Name this tracer's track in merged traces (engine/worker
        name rather than the bare pid)."""
        self.process = str(name)

    # -- thread-local span stack --------------------------------------------
    def _stack(self) -> List[SpanHandle]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, h: SpanHandle) -> None:
        self._stack().append(h)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def current(self) -> Optional[SpanHandle]:
        """Innermost open span on the calling thread, or None."""
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def current_corr(self) -> Optional[str]:
        cur = self.current()
        return cur.corr if cur is not None else None

    def context(self) -> Optional[Tuple[str, int]]:
        """`(trace_id, span_id)` of the innermost open span on this
        thread — the value to carry across a thread or process hop
        and hand back as `span(..., trace=..., parent=...)`."""
        cur = self.current()
        if cur is None:
            return None
        return (cur.trace, cur.span_id)

    def _mint_trace(self) -> str:
        return f"{self._trace_base}{next(self._trace_ids):08x}"

    # -- span creation ------------------------------------------------------
    def span(self, name: str, corr: Optional[str] = None,
             trace: Optional[str] = None,
             parent: Optional[int] = None, **attrs) -> _SpanCtx:
        """Open a span.  With no explicit anchor, the parent is the
        innermost open span on the calling thread and `corr`/`trace`
        default to its values; a root span mints a fresh trace id.
        `trace`/`parent` anchor the span under a REMOTE parent — the
        receiver side of the `X-Trace-Id`/`X-Parent-Span` hop, or a
        cross-thread hand-off of `context()`."""
        cur = self.current()
        if parent is not None:
            parent_id = int(parent)
        elif cur is not None:
            parent_id = cur.span_id
        else:
            parent_id = 0
        if cur is not None:
            if corr is None:
                corr = cur.corr
            if trace is None:
                trace = cur.trace
        if trace is None:
            trace = self._mint_trace()
        handle = SpanHandle(name, next(self._ids), parent_id, trace,
                            corr, attrs, time.perf_counter())
        return _SpanCtx(self, handle)

    def add_span(self, name: str, t0: float, dur_s: float,
                 corr: Optional[str] = None,
                 trace: Optional[str] = None,
                 parent: Optional[int] = None, **attrs) -> int:
        """Record an already-measured span (`t0` in perf_counter
        seconds) without entering a context manager — the shape the
        router uses for stream stages it can only time across
        generator yields.  Returns the span id (0 on drop)."""
        h = SpanHandle(name, next(self._ids),
                       int(parent) if parent is not None else 0,
                       trace if trace is not None
                       else self._mint_trace(),
                       corr, attrs, t0)
        self._record(h, dur_s)
        return h.span_id

    # -- recording ----------------------------------------------------------
    def _record(self, h: SpanHandle, dur_s: float) -> None:
        try:
            faults.maybe_fault("obs.emit")
            tid = threading.get_ident()
            args: Dict[str, Any] = {"span_id": h.span_id,
                                    "trace": h.trace}
            if h.parent_id:
                args["parent_id"] = h.parent_id
            if h.corr is not None:
                args["corr"] = h.corr
            for k, v in h.attrs.items():
                args[k] = v if isinstance(v, (int, float, str, bool,
                                              type(None))) else str(v)
            ev = {"ph": "X", "cat": "obs", "name": h.name,
                  "pid": os.getpid(), "tid": tid,
                  "ts": round((h._t0 - self._origin) * 1e6, 3),
                  "dur": round(dur_s * 1e6, 3),
                  "args": args}
            with self._lock:
                if self.ring:
                    if len(self._events) == self._events.maxlen:
                        self.evicted += 1
                    self._events.append(ev)
                else:
                    if len(self._events) >= self.max_spans:
                        self.dropped += 1
                        return
                    self._events.append(ev)
                if tid not in self._threads_seen:
                    self._threads_seen[tid] = \
                        threading.current_thread().name
        except Exception:  # noqa: BLE001 — telemetry never kills work
            self.dropped += 1

    def discard_trace(self, trace_id: str) -> int:
        """Tail-based sampling's drop half: remove every buffered
        span of `trace_id`, counting them in `sampled_out`.  Returns
        the number removed."""
        if not trace_id:
            return 0
        with self._lock:
            kept = [e for e in self._events
                    if e["args"].get("trace") != trace_id]
            n = len(self._events) - len(kept)
            if n:
                if self.ring:
                    self._events = deque(kept, maxlen=self.ring)
                else:
                    self._events = kept
                self.sampled_out += n
        return n

    # -- reads / export -----------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def trace_dict(self) -> Dict[str, Any]:
        """The full Chrome trace object (span events + thread/process
        metadata), ready for json.dump or the `GET /trace` wire."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads_seen)
        pid = os.getpid()
        meta = [{"ph": "M", "pid": pid, "tid": 0,
                 "name": "process_name",
                 "args": {"name": self.process}}]
        meta += [{"ph": "M", "pid": pid, "tid": tid,
                  "name": "thread_name", "args": {"name": tname}}
                 for tid, tname in sorted(threads.items())]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "process": self.process, "pid": pid,
                "wall_origin_s": round(self._wall_origin, 6)}

    def export(self, path: str) -> bool:
        """Write the Chrome trace JSON to `path` (parent dirs
        created).  Returns False (and counts a drop) on any failure —
        a full disk must not fail a training run at exit."""
        try:
            faults.maybe_fault("obs.emit")
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.trace_dict(), f)
            os.replace(tmp, path)
            return True
        except Exception:  # noqa: BLE001
            self.dropped += 1
            return False
