"""Metrics registry: counters, gauges, histograms, and pull-time
collectors, rendered as Prometheus text exposition format.

Two ways in:

  * **owned metrics** — `registry.counter("name")` returns a live
    Counter the caller increments.  Creation is idempotent (same name
    + same type returns the same object), so hot paths can cache the
    handle once.
  * **collectors** — `registry.register_collector(fn)` where `fn()`
    returns an iterable of `Sample` tuples read at scrape time.  This
    is how the four existing stat surfaces (`TimerInfo`,
    `PipelineStats`, `ServeStats`, `HealthMonitor`) join the registry
    WITHOUT any change to their own APIs or snapshot semantics: each
    grows an additive `register_into(registry)` that closes over its
    instance and maps its existing snapshot fields to samples.  A
    collector that raises is skipped (and counted in
    `collector_errors`) — a broken stat surface must not take down
    /metrics.

`render_prometheus()` emits `# HELP` / `# TYPE` / sample lines; names
are sanitized to the Prometheus charset (dots and dashes become
underscores).  `snapshot()` returns the same data as a flat dict for
the JSONL event-log exporter on the training side.

The port's own copy of `singa_tpu/obs/metrics.py`, which is JAX-free
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple


class Sample(NamedTuple):
    """One scrape-time sample from a collector.

    `labels` is an optional tuple of (key, value) pairs rendered as
    `name{key="value",...}`.  Samples sharing a name (differing only
    in labels) render one HELP/TYPE header followed by every series —
    how `singa_compiles_total{program=...}` fans out per program."""
    name: str
    mtype: str          # "counter" | "gauge" | "histogram"(owned only)
    help: str
    value: float
    labels: Tuple[Tuple[str, str], ...] = ()


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


#: default histogram buckets: latency-ish, seconds
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each
    `le`-bucket counts observations <= its bound, plus +Inf)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) — the raw
        (non-cumulative) counts; rendering accumulates."""
        with self._lock:
            return list(self._counts), self._sum, self._count


def sanitize(name: str) -> str:
    """Map an arbitrary metric name onto the Prometheus charset."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s or "_"


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    """Render a Sample's label pairs as `{k="v",...}` (empty string
    when unlabeled).  Values are escaped per the exposition format."""
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        s = str(v).replace("\\", "\\\\").replace('"', '\\"')
        s = s.replace("\n", "\\n")
        parts.append(f'{sanitize(str(k))}="{s}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    if v != v:          # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """See module docstring.  Instances are independent — the serving
    tier builds one per server so tests never cross-pollute; the
    training side's Observability session owns one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []
        self.collector_errors = 0

    # -- owned metrics ------------------------------------------------------
    def _get(self, name: str, help: str, cls, **kw):
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if not isinstance(got, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(got).__name__}, not {cls.__name__}")
                return got
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(name, help, Histogram, buckets=buckets)

    # -- collectors ---------------------------------------------------------
    def register_collector(self,
                           fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> List[Sample]:
        with self._lock:
            collectors = list(self._collectors)
        out: List[Sample] = []
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — a broken surface must
                self.collector_errors += 1    # not take down /metrics
        return out

    # -- render -------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: List[str] = []
        with self._lock:
            owned = list(self._metrics.values())
        for m in owned:
            name = sanitize(m.name)
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                counts, total, n = m.snapshot()
                acc = 0
                for b, c in zip(m.buckets, counts):
                    acc += c
                    lines.append(
                        f'{name}_bucket{{le="{_fmt(b)}"}} {acc}')
                acc += counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{name}_sum {_fmt(total)}")
                lines.append(f"{name}_count {n}")
            else:
                kind = ("counter" if isinstance(m, Counter) else
                        "gauge")
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {_fmt(m.value)}")
        headed = set()
        for s in self._collect():
            name = sanitize(s.name)
            if name not in headed:       # one HELP/TYPE per name even
                headed.add(name)         # when labels fan out series
                if s.help:
                    lines.append(f"# HELP {name} {s.help}")
                lines.append(f"# TYPE {name} {s.mtype}")
            labels = _label_str(getattr(s, "labels", ()))
            lines.append(f"{name}{labels} {_fmt(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} view (owned + collected) for the JSONL
        metrics exporter.  Histograms contribute `_sum`/`_count`."""
        out: Dict[str, float] = {}
        with self._lock:
            owned = list(self._metrics.values())
        for m in owned:
            name = sanitize(m.name)
            if isinstance(m, Histogram):
                _, total, n = m.snapshot()
                out[name + "_sum"] = total
                out[name + "_count"] = n
            else:
                out[name] = m.value
        for s in self._collect():
            labels = _label_str(getattr(s, "labels", ()))
            out[sanitize(s.name) + labels] = s.value
        return out


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal parser for the text exposition format — enough for
    tests and the smoke script to assert /metrics agrees with /stats.
    Returns {sample_name_with_labels: value}; raises ValueError on a
    line that is neither a comment nor `name[{labels}] value`."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            raise ValueError(f"bad exposition line {lineno}: {line!r}")
        name, val = parts
        base = name.split("{", 1)[0]
        if not base or not all(c.isalnum() or c in "_:" for c in base):
            raise ValueError(f"bad metric name at line {lineno}: "
                             f"{name!r}")
        try:
            out[name] = float(val)
        except ValueError as e:
            raise ValueError(f"bad value at line {lineno}: "
                             f"{val!r}") from e
    return out
