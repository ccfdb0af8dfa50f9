"""Serving-tier counters — the inference-side sibling of
`data.pipeline.PipelineStats`.

The port's own copy of `singa_tpu/serve/stats.py` (JAX-free there too;
the port imports nothing of the JAX package).

One `ServeStats` instance is shared by the `InferenceEngine` (compile /
reload accounting), the `MicroBatcher` (admission / batching / latency),
and the `InferenceServer` (the /stats endpoint).  All mutation goes
through the lock; `snapshot()` is the single read surface, so the HTTP
handler, the bench smoke, and tests all see the same semantics:

  * latency quantiles (p50/p95) come from a bounded reservoir of the
    most recent completions — a serving dashboard number, not an exact
    all-time percentile;
  * `occupancy` is real requests / bucket batch slots averaged over
    dispatched micro-batches (1.0 = every padded slot carried a real
    request);
  * `qps` is completed requests over the stats object's lifetime
    (decays on an idle server — a health dashboard should read
    `qps_recent`, completions within the last `qps_window_s` seconds,
    next to `uptime_s`);
  * `compiles` counts engine program compilations — a warmed server
    must hold this constant (the zero-recompile acceptance gate);
  * `observe_request` splits each completion's total latency into
    queue-wait vs service time and records generated tokens + tok/s
    (p50/p95 of each in `snapshot()`) — the attribution a bare
    end-to-end percentile can't give;
  * `observe_cb_step` feeds the continuous-batching occupancy pair:
    `cb_slot_occupancy` (active slots / compiled slots, averaged over
    scheduler steps) and `cb_block_utilization` (KV blocks in use /
    pool size).

`register_into(registry)` additionally exposes every snapshot field
through an `obs.MetricsRegistry` pull-time collector (the /metrics
Prometheus endpoint) without changing any of the above.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from .tenancy import TenantCounts


class ServeStats:
    """Thread-safe serving counters.  See module docstring."""

    def __init__(self, latency_window: int = 2048,
                 qps_window_s: float = 30.0):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # per-tenant engine-level accounting (serve/tenancy.py):
        # bounded-cardinality labels, exported as singa_tenant_* by
        # register_into.  Callers pass registry-FOLDED labels.
        self.tenants = TenantCounts(
            ("submitted", "completed", "shed"))
        self._latencies: deque = deque(maxlen=max(int(latency_window), 1))
        # the total-latency split (observe_request): time in queue
        # before dispatch/admission vs time being served, plus the
        # per-request generated-token count and tok/s — the
        # attribution a bare p50/p95 gap is missing
        self._queue_waits: deque = deque(
            maxlen=max(int(latency_window), 1))
        self._services: deque = deque(maxlen=max(int(latency_window), 1))
        self._tok_rates: deque = deque(maxlen=max(int(latency_window), 1))
        # completion timestamps for the windowed QPS (bounded: at most
        # latency_window recent completions contribute)
        self.qps_window_s = max(float(qps_window_s), 0.001)
        self._completions: deque = deque(
            maxlen=max(int(latency_window), 1))
        # timestamped reservoirs for the windowed() view (autoscaler
        # control inputs): (stamp, latency) per completion, stamps per
        # shed
        self._timed_lats: deque = deque(
            maxlen=max(int(latency_window), 1))
        self._shed_t: deque = deque(maxlen=max(int(latency_window), 1))
        # (stamp, active_slots) per scheduler step: the lifetime
        # cb_slot_occupancy average can't fall after the scheduler
        # idles (no steps, no new samples), so the autoscaler reads
        # occupancy over a trailing window instead
        self._cb_t: deque = deque(maxlen=8192)
        # admission / completion
        self.submitted = 0
        self.completed = 0
        self.failed = 0          # engine/batch errors surfaced to requests
        self.expired = 0         # deadline passed before dispatch
        self.expired_on_arrival = 0  # dead on arrival: never queued,
                                     # never prefilled — zero engine
                                     # steps burned (serve/qos.py)
        self.cancelled = 0       # cancelled by the caller (hedge loser)
        self.shed = 0            # admission rejected (queue full / fault)
        # per-class brownout accounting (every class shed also counts
        # in `shed`; these split it by priority)
        self.shed_interactive = 0
        self.shed_batch = 0
        self.shed_best_effort = 0
        self.rejected = 0        # never-servable request (fast 400)
        self.resumed = 0         # admissions that re-entered with a
                                 # resume_from prefix (stream failover)
        self.queue_depth = 0     # gauge: requests waiting right now
        self.generated_tokens = 0
        # continuous batching (serve/scheduler.py)
        self.cb_steps = 0             # scheduler iterations run
        self.cb_active_slot_steps = 0  # sum of active slots per step
        self.cb_block_use_steps = 0    # sum of blocks in use per step
        self.cb_slot_capacity = 0      # gauge: compiled slot count S
        self.cb_blocks_total = 0       # gauge: usable pool blocks
        self.cb_blocks_in_use = 0      # gauge: blocks held right now
        # batching
        self.batches = 0
        self.batched_requests = 0
        self.batch_slots = 0     # sum of bucket batch sizes dispatched
        # gauge: dispatched batches failed in a row (reset by any
        # successful batch) — the wedged-engine signal /healthz
        # degrades on once it crosses ServeSpec.degraded_after
        self.consecutive_batch_failures = 0
        # engine
        self.compiles = 0
        self.reloads = 0
        self.reload_failures = 0   # restore raised → kept old params
        self.reloads_refused = 0   # nothing newer / unhealthy walk-back
        self.torn_polls = 0        # poll raced a live writer → no change
        self.reload_poll_deaths = 0  # poll daemon died on an
                                     # unexpected exception (restarted
                                     # under Backoff; /healthz degrades
                                     # on a persistent streak)
        # real Prometheus histograms (cumulative buckets + _sum/_count)
        # created by register_into(); None until then so the hot path
        # costs one attribute check when /metrics is not wired
        self._hist_latency = None
        self._hist_queue_wait = None
        self._hist_service = None

    # -- mutation ----------------------------------------------------------
    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
            if field == "shed":
                self._shed_t.extend([time.monotonic()] * n)

    def gauge(self, field: str, value: int) -> None:
        with self._lock:
            # a typo'd field must fail loudly (AttributeError), not
            # silently create a new attribute no snapshot ever reads —
            # the same implicit validation count()'s getattr performs
            getattr(self, field)
            setattr(self, field, value)

    def observe_batch(self, requests: int, slots: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += requests
            self.batch_slots += slots
            self.consecutive_batch_failures = 0

    def observe_batch_failure(self) -> None:
        with self._lock:
            self.consecutive_batch_failures += 1

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self.completed += 1
            self._latencies.append(seconds)
            now = time.monotonic()
            self._completions.append(now)
            self._timed_lats.append((now, seconds))
        if self._hist_latency is not None:
            self._hist_latency.observe(float(seconds))

    def observe_request(self, queue_wait_s: float, service_s: float,
                        ntokens: int) -> None:
        """Attribute one completed request: time queued before
        dispatch vs time being served, and its generated-token count
        (tok/s recorded when both are positive).  Called next to
        `observe_latency` by both the MicroBatcher and the
        ContinuousScheduler."""
        with self._lock:
            self._queue_waits.append(max(queue_wait_s, 0.0))
            self._services.append(max(service_s, 0.0))
            self.generated_tokens += int(ntokens)
            if ntokens > 0 and service_s > 0:
                self._tok_rates.append(ntokens / service_s)
        if self._hist_queue_wait is not None:
            self._hist_queue_wait.observe(max(float(queue_wait_s), 0.0))
        if self._hist_service is not None:
            self._hist_service.observe(max(float(service_s), 0.0))

    def observe_cb_step(self, active_slots: int,
                        blocks_in_use: int) -> None:
        with self._lock:
            self.cb_steps += 1
            self.cb_active_slot_steps += int(active_slots)
            self.cb_block_use_steps += int(blocks_in_use)
            self._cb_t.append((time.monotonic(), int(active_slots)))

    # -- reads -------------------------------------------------------------
    def latency_quantile(self, q: float) -> Optional[float]:
        """Seconds at quantile `q` (p50/p95/p99 in snapshot) over the
        recent-completion reservoir (nearest-rank), or None before any
        completion."""
        with self._lock:
            lats = sorted(self._latencies)
        if not lats:
            return None
        idx = min(int(q * len(lats)), len(lats) - 1)
        return lats[idx]

    def split_quantile(self, kind: str, q: float) -> Optional[float]:
        """Nearest-rank quantile over one of the observe_request
        reservoirs: kind in ("queue_wait", "service",
        "tokens_per_s")."""
        src = {"queue_wait": self._queue_waits,
               "service": self._services,
               "tokens_per_s": self._tok_rates}[kind]
        with self._lock:
            vals = sorted(src)
        if not vals:
            return None
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def cb_slot_occupancy(self) -> Optional[float]:
        """Active slots / compiled slots averaged over scheduler
        steps (the cb sibling of `occupancy`)."""
        with self._lock:
            if self.cb_steps == 0 or self.cb_slot_capacity == 0:
                return None
            return self.cb_active_slot_steps / (
                self.cb_steps * self.cb_slot_capacity)

    def cb_slot_occupancy_recent(
            self, window_s: float = 5.0) -> Optional[float]:
        """TIME-weighted slot occupancy over the trailing window:
        slot-seconds actually spent decoding / (window x capacity).
        The per-step lifetime average is wrong twice for a scale-down
        signal — it never falls once the scheduler idles (no steps, no
        new samples), and a scheduler that only steps while busy
        averages high even at 1 rps.  Here the gaps BETWEEN steps
        count as idle time (per-step credit capped at 0.25s so a
        stalled scheduler can't bank a giant interval), so this reads
        ~1.0 under saturation and decays toward 0.0 within `window_s`
        of the last request.  None before any cb step (cb off or not
        yet warmed)."""
        now = time.monotonic()
        with self._lock:
            if self.cb_steps == 0 or self.cb_slot_capacity == 0:
                return None
            window = min(float(window_s), max(now - self._t0, 1e-6))
            cutoff = now - window
            entries = [(t, a) for t, a in self._cb_t if t >= cutoff]
            capacity = self.cb_slot_capacity
        if not entries:
            return 0.0
        busy = 0.0
        prev = cutoff
        for t, a in entries:
            busy += a * min(max(t - prev, 0.0), 0.25)
            prev = t
        return min(busy / (window * capacity), 1.0)

    def cb_block_utilization(self) -> Optional[float]:
        with self._lock:
            if self.cb_steps == 0 or self.cb_blocks_total == 0:
                return None
            return self.cb_block_use_steps / (
                self.cb_steps * self.cb_blocks_total)

    def occupancy(self) -> Optional[float]:
        with self._lock:
            if self.batch_slots == 0:
                return None
            return self.batched_requests / self.batch_slots

    def qps(self) -> float:
        with self._lock:
            dt = time.monotonic() - self._t0
            return self.completed / dt if dt > 0 else 0.0

    def uptime_s(self) -> float:
        return time.monotonic() - self._t0

    def qps_recent(self) -> float:
        """Completions within the last `qps_window_s` seconds over
        that window (capped at uptime while the server is younger than
        the window) — 0.0 the moment traffic stops, where the lifetime
        `qps` only decays asymptotically."""
        now = time.monotonic()
        with self._lock:
            window = min(self.qps_window_s, max(now - self._t0, 1e-6))
            cutoff = now - window
            n = sum(1 for t in self._completions if t >= cutoff)
        return n / window

    def windowed(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Rates over the trailing window (default `qps_window_s`,
        capped at uptime) — the engine-level sibling of
        `RouterStats.windowed()`.  shed_rate is sheds over admission
        attempts (sheds + completions) inside the window."""
        now = time.monotonic()
        with self._lock:
            window = float(window_s if window_s is not None
                           else self.qps_window_s)
            window = min(window, max(now - self._t0, 1e-6))
            cut = now - window
            shed = sum(1 for t in self._shed_t if t >= cut)
            lats = sorted(l for t, l in self._timed_lats if t >= cut)

        def q(frac):
            if not lats:
                return None
            return round(
                lats[min(int(frac * len(lats)), len(lats) - 1)] * 1e3, 3)
        return {
            "window_s": round(window, 3),
            "completed": len(lats),
            "shed": shed,
            "qps": round(len(lats) / window, 3),
            "shed_rate": round(shed / max(shed + len(lats), 1), 4),
            "p50_latency_ms": q(0.5),
            "p95_latency_ms": q(0.95),
            "p99_latency_ms": q(0.99),
        }

    def register_into(self, registry,
                      prefix: str = "singa_serve") -> None:
        """Register every snapshot field into an `obs.MetricsRegistry`
        as a pull-time collector (counters for the monotonic tallies,
        gauges for the derived/point-in-time values) — additive;
        snapshot() semantics are untouched, so /metrics and /stats
        agree by construction."""
        from ..obs.metrics import Sample

        counters = ("submitted", "completed", "failed", "expired",
                    "expired_on_arrival", "cancelled", "shed",
                    "shed_interactive", "shed_batch",
                    "shed_best_effort", "rejected", "resumed",
                    "generated_tokens", "batches",
                    "batched_requests", "batch_slots", "cb_steps",
                    "compiles", "reloads", "reload_failures",
                    "reloads_refused", "torn_polls",
                    "reload_poll_deaths")
        gauges = ("queue_depth", "consecutive_batch_failures", "qps",
                  "qps_recent", "uptime_s", "p50_latency_ms",
                  "p95_latency_ms", "p99_latency_ms",
                  "shed_rate_recent", "p95_latency_recent_ms",
                  "p99_latency_recent_ms", "p50_queue_wait_ms",
                  "p95_queue_wait_ms", "p50_service_ms",
                  "p95_service_ms", "p50_tokens_per_s",
                  "p95_tokens_per_s", "batch_occupancy",
                  "cb_slot_occupancy", "cb_slot_occupancy_recent",
                  "cb_block_utilization",
                  "cb_blocks_in_use", "cb_blocks_total")

        def collect():
            snap = self.snapshot()
            out = [Sample(f"{prefix}_{k}_total", "counter",
                          f"serving counter {k!r}", float(snap[k]))
                   for k in counters]
            out += [Sample(f"{prefix}_{k}", "gauge",
                           f"serving gauge {k!r}", float(snap[k]))
                    for k in gauges if snap.get(k) is not None]
            return out

        registry.register_collector(collect)
        # per-tenant labeled series (bounded cardinality — see
        # tenancy.TenantCounts); engine-level registries never collide
        # with the router's because each server owns its own registry
        self.tenants.register_into(registry)
        # real histograms (cumulative le buckets + _sum/_count) next
        # to the reservoir quantiles: the reservoir gives honest
        # recent p50/p95, the histogram aggregates across scrapes and
        # fleet members the way Prometheus expects
        self._hist_latency = registry.histogram(
            f"{prefix}_request_latency_seconds",
            "end-to-end request latency on this engine")
        self._hist_queue_wait = registry.histogram(
            f"{prefix}_queue_wait_seconds",
            "time queued before dispatch/admission")
        self._hist_service = registry.histogram(
            f"{prefix}_service_seconds",
            "time being served after dispatch")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view for /stats."""
        p50, p95, p99 = (self.latency_quantile(0.50),
                         self.latency_quantile(0.95),
                         self.latency_quantile(0.99))
        occ = self.occupancy()
        cb_occ = self.cb_slot_occupancy()
        cb_occ_recent = self.cb_slot_occupancy_recent()
        cb_util = self.cb_block_utilization()
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "expired": self.expired,
                "expired_on_arrival": self.expired_on_arrival,
                "cancelled": self.cancelled,
                "shed": self.shed,
                "shed_interactive": self.shed_interactive,
                "shed_batch": self.shed_batch,
                "shed_best_effort": self.shed_best_effort,
                "rejected": self.rejected,
                "resumed": self.resumed,
                "queue_depth": self.queue_depth,
                "generated_tokens": self.generated_tokens,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "batch_slots": self.batch_slots,
                "cb_steps": self.cb_steps,
                "cb_blocks_in_use": self.cb_blocks_in_use,
                "cb_blocks_total": self.cb_blocks_total,
                "consecutive_batch_failures":
                    self.consecutive_batch_failures,
                "compiles": self.compiles,
                "reloads": self.reloads,
                "reload_failures": self.reload_failures,
                "reloads_refused": self.reloads_refused,
                "torn_polls": self.torn_polls,
                "reload_poll_deaths": self.reload_poll_deaths,
            }
        out["qps"] = round(self.qps(), 3)
        out["qps_recent"] = round(self.qps_recent(), 3)
        win = self.windowed()
        out["shed_rate_recent"] = win["shed_rate"]
        out["p95_latency_recent_ms"] = win["p95_latency_ms"]
        out["p99_latency_recent_ms"] = win["p99_latency_ms"]
        out["uptime_s"] = round(self.uptime_s(), 3)
        out["p50_latency_ms"] = (round(p50 * 1e3, 3)
                                 if p50 is not None else None)
        out["p95_latency_ms"] = (round(p95 * 1e3, 3)
                                 if p95 is not None else None)
        out["p99_latency_ms"] = (round(p99 * 1e3, 3)
                                 if p99 is not None else None)
        for kind, label in (("queue_wait", "queue_wait_ms"),
                            ("service", "service_ms")):
            for q, pre in ((0.50, "p50"), (0.95, "p95")):
                v = self.split_quantile(kind, q)
                out[f"{pre}_{label}"] = (round(v * 1e3, 3)
                                         if v is not None else None)
        for q, pre in ((0.50, "p50"), (0.95, "p95")):
            v = self.split_quantile("tokens_per_s", q)
            out[f"{pre}_tokens_per_s"] = (round(v, 3)
                                          if v is not None else None)
        out["batch_occupancy"] = (round(occ, 4) if occ is not None
                                  else None)
        out["cb_slot_occupancy"] = (round(cb_occ, 4)
                                    if cb_occ is not None else None)
        out["cb_slot_occupancy_recent"] = (
            round(cb_occ_recent, 4)
            if cb_occ_recent is not None else None)
        out["cb_block_utilization"] = (round(cb_util, 4)
                                       if cb_util is not None else None)
        out["by_tenant"] = self.tenants.snapshot()
        return out
