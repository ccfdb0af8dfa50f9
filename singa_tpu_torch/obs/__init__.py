"""Unified observability: span tracing, a metrics registry, a
structured JSONL event log, and component loggers — one layer across
training (Supervisor/Trainer/feeder/checkpoints) and serving
(batcher/engine/server).

The reference's only telemetry was the per-phase timer report
(worker.h:91-114); this package is the cross-cutting read surface the
ROADMAP's remaining items (fleet router health, canary promotion,
pipeline mode) consume.  Four rules:

  1. **~zero cost off.**  `obs.span(...)` / `obs.emit_event(...)` are
     a module-global read (and, for `span`, torch.profiler's flag) when
     no session is active — the same discipline as
     `faults.maybe_fault`.  Instrumented hot paths pay nothing until
     `--obs on` or a profiler.
  2. **telemetry never kills work.**  Every record/write path consults
     the `obs.emit` fault site and swallows ALL failures into drop
     counters (`tests/test_obs.py` proves a faulted emit still
     completes the step / the request).
  3. **existing surfaces keep their semantics.**  `TimerInfo`,
     `PipelineStats`, `ServeStats`, `HealthMonitor` register into the
     `MetricsRegistry` through additive `register_into` collectors —
     their own APIs and snapshots are unchanged.
  4. **correlation across tiers AND processes.**  Spans inherit their
     parent's correlation id on the same thread; cross-thread
     hand-offs pass `obs.current_corr()` / `obs.trace_context()`
     explicitly; cross-PROCESS hops carry the trace context as the
     `X-Trace-Id`/`X-Parent-Span` header pair (serve/qos.py) and the
     receiver re-anchors with `obs.span(..., trace=..., parent=...)`.
     A request flows req→batch→engine; a recovery flows
     attempt→restore→chunks; a fleet request flows
     frontend→dispatch→worker with ONE trace id end to end.

CLI: `--obs on|off` plus `--obs_spec 'trace=path,events=path,
metrics_period_s=5'` (main.py), mirroring `--health_spec`.  Artifacts:
a Chrome trace JSON, a JSONL event log, and flight-recorder dumps
(`flightrec.py`); `collect.py` merges per-process buffers into one
fleet trace.  See docs/OBSERVABILITY.md.

The Tracer's file and a device trace do not share a clock: the Tracer
stamps microseconds from its own `perf_counter` origin, torch.profiler's
export microseconds from its `baseTimeNanoseconds`, an instant of the
Unix epoch.  So while a torch.profiler
session collects, `span` also opens a `record_function` range of the
span's name: the span then lands in the profiler's own export, as a
`user_annotation` event on its clock beside the card's kernels, with or
without an obs session.  (A profiler records the ranges of the threads
it profiles: the one that started it, or every thread where it was
started with `profile_all_threads`.)  `utils/profiler.phase` is such a
span, so the port has one span API.

The port's own copy of `singa_tpu/obs/__init__.py`.  Its Supervisor,
trainer, feeder, checkpoints, train-and-serve pipeline
(`core/pipeline.py`) and serving tier (engine, scheduler, batcher,
server, wire, router, fleet, autoscaler) report through this layer.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional, Tuple

from . import perf
from .flightrec import FlightRecorder
from .log import EventLog, Logger, MetricsDumper
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      Sample, parse_prometheus)
from .trace import NULL_HANDLE, NULL_SPAN, ProfiledSpan, Tracer, profiling

__all__ = [
    "ObsSpec", "Observability", "TailSampler", "enable", "disable",
    "active", "session", "span", "current_corr", "trace_context",
    "trace_dump", "emit_event", "sample_trace", "get_logger",
    "registry", "Tracer", "FlightRecorder", "MetricsRegistry",
    "Counter", "Gauge", "Histogram", "Sample", "EventLog", "Logger",
    "parse_prometheus", "perf",
]


@dataclass
class ObsSpec:
    """`--obs_spec` grammar: comma/semicolon-separated `key=value`
    entries over these fields (the `--health_spec` convention).  Empty
    `trace`/`events` paths disable that exporter; main.py defaults
    both under `<workspace>/obs/` when `--obs on` is given bare."""
    trace: str = ""             # Chrome trace JSON output path
    events: str = ""            # JSONL event log output path
    metrics_period_s: float = 0.0   # >0: periodic metrics → event log
    max_spans: int = 200_000    # in-memory span buffer bound
    max_events_mb: float = 0.0  # >0: rotate the JSONL log at this size
    trace_ring: int = 0         # >0: keep the most recent N spans
                                # instead (the GET /trace serving mode)
    process: str = ""           # process/engine name on merged tracks
    sample: str = "all"         # "all" | "tail" (tail-based sampling)
    sample_slow_ms: float = 0.0     # tail: explicit slow bar; 0 = the
                                    # caller's windowed p95
    flightrec: str = ""         # dir for flightrec-*.json dumps
    flightrec_ring: int = 512   # flight-recorder event ring bound

    _INT = ("max_spans", "trace_ring", "flightrec_ring")
    _STR = ("trace", "events", "process", "sample", "flightrec")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "ObsSpec":
        out = cls()
        if not spec:
            return out
        known = {f.name for f in fields(cls)
                 if not f.name.startswith("_")}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in known:
                raise ValueError(
                    f"bad obs spec entry {part!r} (want key=value "
                    f"with key in {sorted(known)})")
            val = val.strip()
            try:
                if key in cls._STR:
                    setattr(out, key, val)
                elif key in cls._INT:
                    setattr(out, key, int(val))
                else:
                    setattr(out, key, float(val))
            except ValueError as e:
                raise ValueError(
                    f"bad obs spec value for {key!r}: {val!r}") from e
        if out.sample not in ("all", "tail"):
            raise ValueError(f"bad obs spec value for 'sample': "
                             f"{out.sample!r} (want all|tail)")
        return out


class TailSampler:
    """Tail-based sampling policy (`sample=tail`): keep full traces
    only for INTERESTING requests — slow against the caller-supplied
    windowed p95 (or the explicit `sample_slow_ms` bar), failed, shed,
    hedged, or resumed — and count-then-drop the rest.  With
    `sample=all` every trace is kept and this is pure bookkeeping."""

    def __init__(self, spec: ObsSpec):
        self.spec = spec
        self.kept = 0
        self.sampled_out = 0
        self._lock = threading.Lock()

    def keep(self, latency_s: float, p95_s: Optional[float] = None,
             failed: bool = False, shed: bool = False,
             hedged: bool = False, resumed: bool = False) -> bool:
        interesting = True
        if self.spec.sample == "tail":
            if self.spec.sample_slow_ms > 0:
                bar = self.spec.sample_slow_ms / 1000.0
            else:
                bar = p95_s
            interesting = bool(
                failed or shed or hedged or resumed
                or (bar is not None and latency_s > bar))
        with self._lock:
            if interesting:
                self.kept += 1
            else:
                self.sampled_out += 1
        return interesting

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"policy": self.spec.sample, "kept": self.kept,
                    "sampled_out": self.sampled_out}


class Observability:
    """One live session: a tracer, a metrics registry, an optional
    event log, the periodic metrics dumper, the tail sampler, and an
    optional flight recorder.  Built by `enable`, torn down (trace
    exported, log closed) by `disable`."""

    def __init__(self, spec: Optional[ObsSpec] = None):
        self.spec = spec or ObsSpec()
        self.tracer = Tracer(max_spans=self.spec.max_spans,
                             ring=self.spec.trace_ring,
                             process=self.spec.process or None)
        self.registry = MetricsRegistry()
        # the performance observatory and the process collector ride
        # on every session registry (perf.register_into survives
        # perf.reset(): its collector re-reads the singleton)
        perf.register_into(self.registry)
        perf.register_process_into(self.registry)
        self.sampler = TailSampler(self.spec)
        self.events: Optional[EventLog] = (
            EventLog(self.spec.events,
                     max_bytes=int(self.spec.max_events_mb
                                   * 1024 * 1024))
            if self.spec.events else None)
        self.flightrec: Optional[FlightRecorder] = (
            FlightRecorder(self.spec.flightrec,
                           ring=self.spec.flightrec_ring,
                           extra_fn=perf.flightrec_context)
            if self.spec.flightrec else None)
        self._dumper: Optional[MetricsDumper] = (
            MetricsDumper(self.registry, self.events,
                          self.spec.metrics_period_s)
            if self.events is not None
            and self.spec.metrics_period_s > 0 else None)

    def flush(self) -> None:
        """Export the trace, final-dump metrics, close the event
        log.  Safe to call more than once; never raises.  A faulted
        flush (`obs.flush` site) is itself a flight-recorder trigger
        — the one teardown whose loss the recorder must survive."""
        try:
            from ..utils import faults
            try:
                faults.maybe_fault("obs.flush")
            except Exception:  # noqa: BLE001 — flush fault = trigger
                if self.flightrec is not None:
                    self.flightrec.trigger("obs.flush_fault",
                                           tracer=self.tracer)
            if self._dumper is not None:
                self._dumper.stop(final_dump=True)
                self._dumper = None
            if self.spec.trace:
                self.tracer.export(self.spec.trace)
            if self.events is not None:
                self.events.emit(
                    "obs.flush",
                    spans=len(self.tracer.events()),
                    spans_dropped=self.tracer.dropped,
                    spans_evicted=self.tracer.evicted,
                    spans_sampled_out=self.tracer.sampled_out,
                    events_written=self.events.written,
                    events_dropped=self.events.dropped,
                    events_rotations=self.events.rotations)
                self.events.close()
        except Exception:  # noqa: BLE001 — teardown never raises
            pass


_LOCK = threading.Lock()
_ACTIVE: Optional[Observability] = None


def enable(spec: Optional[ObsSpec] = None) -> Observability:
    """Install a process-global session (replacing — and flushing —
    any previous one).  Returns it."""
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, Observability(spec)
    if prev is not None:
        prev.flush()
    return _ACTIVE


def disable() -> None:
    """Flush and remove the active session.  No-op when off."""
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, None
    if prev is not None:
        prev.flush()


def active() -> Optional[Observability]:
    return _ACTIVE


class session:
    """`with obs.session(spec): ...` — enable for the body, flush on
    exit (tests and bench legs)."""

    def __init__(self, spec: Optional[ObsSpec] = None):
        self._spec = spec

    def __enter__(self) -> Observability:
        return enable(self._spec)

    def __exit__(self, *exc) -> bool:
        disable()
        return False


# -- the instrumented-site API (hot-path: one global read when off) ---------

def span(name: str, corr: Optional[str] = None,
         trace: Optional[str] = None, parent: Optional[int] = None,
         **attrs):
    """Open a trace span, or the shared null span when no session is
    active and no torch.profiler collects.  While a profiler collects
    the span is also a `record_function` range of `name` (see the
    module docstring); `attrs` reach the session's Tracer only.
    `trace`/`parent` anchor under a remote or cross-thread parent
    (the receive side of an `X-Trace-Id`/`X-Parent-Span` hop)."""
    o = _ACTIVE
    inner = NULL_SPAN if o is None else o.tracer.span(
        name, corr=corr, trace=trace, parent=parent, **attrs)
    return ProfiledSpan(name, inner) if profiling() else inner


def current_corr() -> Optional[str]:
    """Correlation id of the innermost open span on this thread (for
    explicit cross-thread hand-off), or None."""
    o = _ACTIVE
    if o is None:
        return None
    return o.tracer.current_corr()


def trace_context() -> Optional[Tuple[str, int]]:
    """`(trace_id, span_id)` of the innermost open span on this
    thread — the value a sender serializes into the
    `X-Trace-Id`/`X-Parent-Span` pair — or None when off / no span."""
    o = _ACTIVE
    if o is None:
        return None
    return o.tracer.context()


def trace_dump() -> Dict[str, Any]:
    """The active tracer's Chrome-trace dict (the `GET /trace` body);
    an empty trace when no session is live."""
    o = _ACTIVE
    if o is None:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    return o.tracer.trace_dict()


def emit_event(kind: str, **fields) -> None:
    """Append a structured event to the active session's JSONL log
    and the flight recorder's ring.  No-op when off; any failure is
    swallowed into the respective drop counter."""
    o = _ACTIVE
    if o is None:
        return
    if o.events is not None:
        o.events.emit(kind, **fields)
    if o.flightrec is not None:
        o.flightrec.observe(kind, fields, tracer=o.tracer)


def sample_trace(trace_id: Optional[str], latency_s: float,
                 p95_s: Optional[float] = None, failed: bool = False,
                 shed: bool = False, hedged: bool = False,
                 resumed: bool = False) -> bool:
    """Apply the session's tail-sampling policy to one finished
    request: returns True when its trace is kept, else discards the
    buffered spans (counted, never raised).  No-op (kept) when off."""
    o = _ACTIVE
    if o is None:
        return True
    keep = o.sampler.keep(latency_s, p95_s=p95_s, failed=failed,
                          shed=shed, hedged=hedged, resumed=resumed)
    if not keep and trace_id:
        o.tracer.discard_trace(trace_id)
    return keep


def registry() -> Optional[MetricsRegistry]:
    """The active session's metrics registry, or None when off."""
    o = _ACTIVE
    return o.registry if o is not None else None


def get_logger(component: str,
               sink: Optional[Callable[..., None]] = None) -> Logger:
    """A component logger usable anywhere a bare `log_fn` is —
    resolves the active event log per call, so it mirrors warning+
    records whenever a session is live."""
    return Logger(component, sink=sink,
                  event_log_for=lambda: (
                      _ACTIVE.events if _ACTIVE is not None else None))
