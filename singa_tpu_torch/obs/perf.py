"""Performance observatory: capture, memory, and per-program cost
accounting.

The port's counterpart of `singa_tpu/obs/perf.py`: three watchers
folded into one process-global `PerfWatch`.

  * **CompileWatch** — the JAX package times every
    `jit(...).lower(...).compile()`; the port's programs are CUDA
    graphs, so here a "compile" is a CUDA-graph capture.  Each engine
    capture (a bucket program, the cb prefill and decode step) runs
    inside `compile_span(program, geometry, scope)`, recording its
    duration into the `singa_compile_seconds` histogram and per-program
    `singa_compiles_total{program=...}` counters.  Scopes model "no
    capture after warmup" at runtime: each engine marks its scope warm
    per mode family at the end of `warmup()`, and any later capture in
    a warm (scope, family) is an anomaly — counted, emitted as a
    `perf.recompile_anomaly` event, and (via the flight recorder's
    trigger table) dumped as evidence.
  * **MemoryWatch** — per-device live/peak bytes from
    `torch.cuda.memory_stats()` (none on the CPU), with an analytic
    fallback built from registered components (served param bytes,
    PagedKVCache pool bytes from block geometry).  A high-watermark
    gauge tracks the worst total ever observed and is surfaced both in
    /metrics and in flight-recorder dumps.
  * **CostWatch** — each program's FLOPs, harvested by its owner
    (`harvest(program, flops=...)`): the trainer records the analytic
    count of its train and eval steps (`utils/flops.py`; their K1-K6
    launches are invisible to a FLOP counter), the engine what
    `counted_flops` counted on each program's eager warm-up call.  A
    CUDA graph carries no cost analysis, so nothing is read off a
    captured program; nothing counts the bytes a program moves either,
    so the JAX package's `singa_program_bytes` and arithmetic intensity
    have no counterpart.  `observe_step` keeps each program's latest
    wall time, and `collect()` derives `singa_program_mfu` from the two
    and the card's peak.

Cold-start readiness rides along: `mark_serving_ready()` /
`mark_training_ready()` are first-call-wins latches measuring process
start (from /proc where available) to first warm token / first
completed train dispatch, exported as
`singa_restart_to_serving_seconds` / `singa_restart_to_training_seconds`.

Everything here is host-side bookkeeping in the nanosecond-to-
microsecond range, always on (like ServeStats counters), and — like
every obs surface — never raises into the work it measures.  The
module-level functions delegate to a swappable singleton so tests and
benches can `perf.reset()` for a clean slate; `register_into()`
registers a thunk that re-reads the singleton, so registries survive
resets.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.flops import peak_flops
from .metrics import Histogram, Sample

#: capture durations run 100ms..minutes, not the request-latency
#: range DEFAULT_BUCKETS covers
COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)

#: per-program compile records kept for snapshots/dumps
MAX_RECORDS = 256


def _process_start_monotonic() -> float:
    """Monotonic timestamp of process birth.  On Linux, derived from
    /proc so readiness timers measure from exec() even when this
    module imports late; elsewhere, import time is the best anchor
    available."""
    try:
        with open("/proc/self/stat") as f:
            # field 22 (starttime) counts clock ticks after the
            # parenthesised comm field, which may itself contain spaces
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])
        hz = float(os.sysconf("SC_CLK_TCK"))
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / hz
        if age >= 0:
            return time.monotonic() - age
    except Exception:  # noqa: BLE001 — non-Linux / hardened /proc
        pass
    return time.monotonic()


_PROCESS_START = _process_start_monotonic()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_bytes(tree) -> int:
    """Total bytes in a (nested) dict of tensors or numpy arrays
    (leaves without shape/dtype — python scalars — count 0)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        total += n * int(np.dtype(dtype).itemsize)
    return total


class PerfWatch:
    """Compile/memory/cost accounting for one process; see module
    docstring.  All mutators take one short lock; `collect()` is the
    scrape-time reader every registered MetricsRegistry shares."""

    def __init__(self):
        self._lock = threading.Lock()
        # CompileWatch
        self.compile_hist = Histogram(
            "singa_compile_seconds",
            "CUDA-graph capture durations across all programs",
            buckets=COMPILE_BUCKETS)
        self._compiles: Dict[str, int] = {}          # program -> count
        self._cache: Dict[Tuple[str, str], int] = {}  # (program, hit|miss)
        self._records: List[Dict[str, Any]] = []
        self._warm: set = set()                      # (scope, family)
        self.anomalies = 0
        # readiness latches (seconds since process start, first win)
        self._serving_ready_s: Optional[float] = None
        self._training_ready_s: Optional[float] = None
        # MemoryWatch: (scope, component) -> bytes; watermark = worst
        # total ever observed across set_memory calls and scrapes
        self._memory: Dict[Tuple[str, str], int] = {}
        self._watermark = 0
        # CostWatch: program -> {"flops":…, "step_seconds":…}
        self._cost: Dict[str, Dict[str, float]] = {}

    # -- CompileWatch -------------------------------------------------------
    @contextmanager
    def compile_span(self, program: str, geometry: str = "",
                     scope: str = "", family: str = ""):
        """Time one real compile.  `scope` identifies the owner whose
        warmup contract applies (one per engine); `family` is the mode
        family the warmup promise covers (defaults to `program`), so
        e.g. a first `predict` compile after a generate-only warmup is
        lazy, not anomalous."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._record_compile(program, geometry, scope,
                                 family or program,
                                 time.perf_counter() - t0)

    def _record_compile(self, program, geometry, scope, family,
                        seconds) -> None:
        with self._lock:
            self._compiles[program] = self._compiles.get(program, 0) + 1
            key = (program, "miss")
            self._cache[key] = self._cache.get(key, 0) + 1
            anomalous = bool(scope) and (scope, family) in self._warm
            if anomalous:
                self.anomalies += 1
            rec = {"program": program, "geometry": geometry,
                   "scope": scope, "seconds": round(seconds, 6),
                   "anomaly": anomalous}
            self._records.append(rec)
            del self._records[:-MAX_RECORDS]
        self.compile_hist.observe(seconds)
        if anomalous:
            # routes to the event log AND the flight recorder, whose
            # trigger table dumps the evidence window (rate-limited)
            try:
                from .. import obs
                obs.emit_event("perf.recompile_anomaly",
                               program=program, geometry=geometry,
                               scope=scope,
                               compile_seconds=round(seconds, 6))
            except Exception:  # noqa: BLE001 — telemetry never kills
                pass

    def lookup_hit(self, program: str) -> None:
        """Count an executable-cache hit on a compile fast path."""
        with self._lock:
            key = (program, "hit")
            self._cache[key] = self._cache.get(key, 0) + 1

    def mark_warm(self, scope: str, family: str = "") -> None:
        """Declare `scope`'s warmup promise for `family`; compiles
        after this in the same (scope, family) are anomalies.  A
        family warmed per mode keeps lazily-compiled OTHER modes
        (e.g. first `predict` after a generate-only warmup) from
        reading as violations."""
        with self._lock:
            self._warm.add((scope, family))

    def is_warm(self, scope: str, family: str = "") -> bool:
        with self._lock:
            return (scope, family) in self._warm

    def compiles_total(self) -> int:
        with self._lock:
            return sum(self._compiles.values())

    # -- readiness ----------------------------------------------------------
    def _latch(self, attr: str) -> float:
        with self._lock:
            got = getattr(self, attr)
            if got is None:
                got = max(time.monotonic() - _PROCESS_START, 1e-9)
                setattr(self, attr, got)
            return got

    def mark_serving_ready(self) -> float:
        """Latch process-start → first warm token (first call wins)."""
        return self._latch("_serving_ready_s")

    def mark_training_ready(self) -> float:
        """Latch process-start → first completed train dispatch."""
        return self._latch("_training_ready_s")

    @property
    def serving_ready_s(self) -> Optional[float]:
        return self._serving_ready_s

    @property
    def training_ready_s(self) -> Optional[float]:
        return self._training_ready_s

    # -- MemoryWatch --------------------------------------------------------
    def set_memory(self, component: str, nbytes: int,
                   scope: str = "") -> None:
        """Register/refresh one analytic HBM component (train_params,
        opt_state, serve_params, kv_pool).  Components are keyed per
        scope so a trainer and an engine in one process don't clobber
        each other."""
        with self._lock:
            self._memory[(scope, component)] = max(int(nbytes), 0)
            total = sum(self._memory.values())
            if total > self._watermark:
                self._watermark = total

    def set_memory_tree(self, component: str, tree,
                        scope: str = "") -> int:
        """`set_memory` from a pytree of arrays; returns the bytes."""
        try:
            nbytes = _tree_bytes(tree)
        except Exception:  # noqa: BLE001
            return 0
        self.set_memory(component, nbytes, scope=scope)
        return nbytes

    def device_memory(self) -> List[Dict[str, Any]]:
        """Live/peak bytes per CUDA device from
        `torch.cuda.memory_stats()`; empty without a card (CPU)."""
        out: List[Dict[str, Any]] = []
        try:
            if not torch.cuda.is_available():
                return out
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                if not stats:
                    continue
                out.append({
                    "device": i,
                    "kind": torch.cuda.get_device_name(i),
                    "live": int(stats.get("allocated_bytes.all.current",
                                          0)),
                    "peak": int(stats.get("allocated_bytes.all.peak", 0)),
                })
        except Exception:  # noqa: BLE001
            return out
        return out

    # -- CostWatch ----------------------------------------------------------
    def harvest(self, program: str, compiled=None,
                flops: Optional[float] = None) -> Dict[str, float]:
        """Record `flops`, the FLOPs of one execution of `program`, when
        positive; merge them into the program's cost entry and return
        it.  `compiled`, the JAX package's compiled executable, has no
        counterpart here: a CUDA graph carries no cost analysis, so the
        owner that counted the program passes its count."""
        with self._lock:
            entry = self._cost.setdefault(program, {})
            if flops and flops > 0:
                entry["flops"] = float(flops)
            return dict(entry)

    def observe_step(self, program: str, seconds: float) -> None:
        """Record the latest wall time of one execution of `program`, so
        that MFU (flops / (seconds · peak)) can be derived at scrape."""
        if seconds <= 0:
            return
        with self._lock:
            self._cost.setdefault(program, {})["step_seconds"] = \
                float(seconds)

    # -- export -------------------------------------------------------------
    def collect(self) -> List[Sample]:
        """Scrape-time samples for MetricsRegistry collectors."""
        with self._lock:
            compiles = dict(self._compiles)
            cache = dict(self._cache)
            anomalies = self.anomalies
            memory = dict(self._memory)
            serving = self._serving_ready_s
            training = self._training_ready_s
            cost = {k: dict(v) for k, v in self._cost.items()}
        out: List[Sample] = []
        for program, n in sorted(compiles.items()):
            out.append(Sample(
                "singa_compiles_total", "counter",
                "CUDA-graph captures per program", float(n),
                (("program", program),)))
        for (program, result), n in sorted(cache.items()):
            out.append(Sample(
                "singa_compile_cache_total", "counter",
                "executable cache lookups per program", float(n),
                (("program", program), ("result", result))))
        _, hsum, hcount = self.compile_hist.snapshot()
        out.append(Sample("singa_compile_seconds_sum", "counter",
                          "total seconds spent compiling", hsum))
        out.append(Sample("singa_compile_seconds_count", "counter",
                          "total compiles timed", float(hcount)))
        out.append(Sample("singa_recompile_anomalies_total", "counter",
                          "captures after warmup (invariant "
                          "violations)", float(anomalies)))
        if serving is not None:
            out.append(Sample("singa_restart_to_serving_seconds",
                              "gauge", "process start to first warm "
                              "token", serving))
        if training is not None:
            out.append(Sample("singa_restart_to_training_seconds",
                              "gauge", "process start to first "
                              "completed train dispatch", training))
        # memory: real device stats when the backend has them, plus
        # the analytic components and their watermark (the fallback —
        # and the only signal on CPU)
        live_total = 0
        peak_total = 0
        for dm in self.device_memory():
            dev = (("device", str(dm["device"])),
                   ("kind", dm["kind"]))
            out.append(Sample("singa_hbm_live_bytes", "gauge",
                              "device bytes in use", float(dm["live"]),
                              dev))
            out.append(Sample("singa_hbm_peak_bytes", "gauge",
                              "device peak bytes in use",
                              float(dm["peak"]), dev))
            live_total += dm["live"]
            peak_total += dm["peak"]
        analytic_total = 0
        by_component: Dict[str, int] = {}
        for (_scope, component), nbytes in memory.items():
            by_component[component] = (by_component.get(component, 0)
                                       + nbytes)
            analytic_total += nbytes
        for component, nbytes in sorted(by_component.items()):
            out.append(Sample("singa_hbm_analytic_bytes", "gauge",
                              "analytic HBM model per component",
                              float(nbytes),
                              (("component", component),)))
        out.append(Sample("singa_hbm_analytic_total_bytes", "gauge",
                          "sum of analytic HBM components",
                          float(analytic_total)))
        with self._lock:
            # scrapes can raise the watermark too (device peak counts)
            observed = max(analytic_total, live_total, peak_total)
            if observed > self._watermark:
                self._watermark = observed
            watermark = self._watermark
        out.append(Sample("singa_hbm_watermark_bytes", "gauge",
                          "high-watermark of observed/modelled HBM",
                          float(watermark)))
        # cost: FLOPs per program; MFU where the peak table knows the
        # card (None on the CPU)
        try:
            peak = peak_flops()
        except Exception:  # noqa: BLE001 — telemetry never kills
            peak = None
        for program, entry in sorted(cost.items()):
            lab = (("program", program),)
            flops = entry.get("flops")
            step = entry.get("step_seconds")
            if flops:
                out.append(Sample("singa_program_flops", "gauge",
                                  "model FLOPs per execution", flops, lab))
            if flops and step and peak:
                out.append(Sample("singa_program_mfu", "gauge",
                                  "achieved FLOP/s over the card's bf16 "
                                  "peak", flops / (step * peak), lab))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Structured view for benches and flight-recorder dumps."""
        with self._lock:
            _, hsum, hcount = self.compile_hist.snapshot()
            by_component: Dict[str, int] = {}
            for (_s, component), nbytes in self._memory.items():
                by_component[component] = (
                    by_component.get(component, 0) + nbytes)
            return {
                "compiles": dict(self._compiles),
                "compiles_total": sum(self._compiles.values()),
                "cache": {f"{p}:{r}": n
                          for (p, r), n in self._cache.items()},
                "compile_seconds_sum": round(hsum, 6),
                "compile_count": hcount,
                "anomalies": self.anomalies,
                "records": list(self._records[-32:]),
                "serving_ready_s": self._serving_ready_s,
                "training_ready_s": self._training_ready_s,
                "memory_components": by_component,
                "hbm_watermark_bytes": self._watermark,
                "cost": {k: dict(v) for k, v in self._cost.items()},
            }

    def flightrec_context(self) -> Dict[str, Any]:
        """Small additive context for flight-recorder dumps: memory
        state and readiness — the numbers a post-mortem asks first."""
        snap = self.snapshot()
        return {"hbm_watermark_bytes": snap["hbm_watermark_bytes"],
                "memory_components": snap["memory_components"],
                "serving_ready_s": snap["serving_ready_s"],
                "training_ready_s": snap["training_ready_s"],
                "compiles_total": snap["compiles_total"],
                "anomalies": snap["anomalies"]}


# -- process-level collector (satellite: every /metrics endpoint) ----------

def process_samples() -> List[Sample]:
    """RSS, thread count, open fds, uptime, CPU time for this process
    — the collector that makes a leaking engine visible.  Registered
    on every MetricsRegistry (trainer session, engine, fleet,
    pipeline).  Sources degrade gracefully off-Linux."""
    out: List[Sample] = []
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out.append(Sample("singa_process_rss_bytes", "gauge",
                          "resident set size",
                          float(rss_pages * os.sysconf("SC_PAGE_SIZE"))))
    except Exception:  # noqa: BLE001
        pass
    out.append(Sample("singa_process_threads", "gauge",
                      "live python threads",
                      float(threading.active_count())))
    try:
        out.append(Sample("singa_process_open_fds", "gauge",
                          "open file descriptors",
                          float(len(os.listdir("/proc/self/fd")))))
    except Exception:  # noqa: BLE001
        pass
    out.append(Sample("singa_process_uptime_seconds", "gauge",
                      "seconds since process start",
                      max(time.monotonic() - _PROCESS_START, 0.0)))
    try:
        t = os.times()
        out.append(Sample("singa_process_cpu_seconds_total", "counter",
                          "user+system CPU seconds",
                          float(t.user + t.system)))
    except Exception:  # noqa: BLE001
        pass
    return out


def register_process_into(registry) -> None:
    """Register the process-level collector on `registry`."""
    registry.register_collector(process_samples)


# -- module-level singleton API --------------------------------------------

_WATCH = PerfWatch()


def watch() -> PerfWatch:
    """The process-global PerfWatch."""
    return _WATCH


def reset() -> PerfWatch:
    """Swap in a fresh PerfWatch (tests/benches).  Registries wired
    via `register_into` keep working: their collector re-reads the
    singleton at every scrape."""
    global _WATCH
    _WATCH = PerfWatch()
    return _WATCH


def register_into(registry) -> None:
    """Register the perf collector (reset-proof) on `registry`."""
    registry.register_collector(lambda: _WATCH.collect())


def compile_span(program: str, geometry: str = "", scope: str = "",
                 family: str = ""):
    return _WATCH.compile_span(program, geometry=geometry,
                               scope=scope, family=family)


def lookup_hit(program: str) -> None:
    _WATCH.lookup_hit(program)


def mark_warm(scope: str, family: str = "") -> None:
    _WATCH.mark_warm(scope, family)


def mark_serving_ready() -> float:
    return _WATCH.mark_serving_ready()


def mark_training_ready() -> float:
    return _WATCH.mark_training_ready()


def set_memory(component: str, nbytes: int, scope: str = "") -> None:
    _WATCH.set_memory(component, nbytes, scope=scope)


def set_memory_tree(component: str, tree, scope: str = "") -> int:
    return _WATCH.set_memory_tree(component, tree, scope=scope)


def harvest(program: str, compiled=None,
            flops: Optional[float] = None) -> Dict[str, float]:
    return _WATCH.harvest(program, compiled, flops=flops)


def observe_step(program: str, seconds: float) -> None:
    _WATCH.observe_step(program, seconds)


def snapshot() -> Dict[str, Any]:
    return _WATCH.snapshot()


def flightrec_context() -> Dict[str, Any]:
    return _WATCH.flightrec_context()
