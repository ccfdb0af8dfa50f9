"""Post-mortem flight recorder: a bounded in-memory ring of recent
events (plus the tracer's freshest spans) that dumps itself to
`<dir>/flightrec-<trigger>-<n>.json` the moment something goes wrong.

The observability trade at fleet rates is that full tracing is
usually off or tail-sampled — and the one night a canary rolls back
at 3am is exactly the night nobody had `--obs_spec trace=...` set.
The recorder closes that gap: it rides along whenever a session is
active (no trace/events exporters required), costs one deque append
per event, and on a trigger writes the last window of events and
spans so the post-mortem starts from evidence instead of from a bare
exit code.

Triggers (docs/OBSERVABILITY.md has the table):

  * `fleet.rollback` / `fleet.canary_abort`  — a rollout went wrong
  * `fleet.quarantine`                       — an engine was struck out
  * `stream.resume`                          — a mid-stream failover
  * shed storm — `serve.shed` events above `SHED_STORM_N` within
    `SHED_STORM_WINDOW_S` (one shed is load; a storm is an incident)
  * divergence — any event whose `verdict`/`status` reads DIVERGED
  * `obs.flush` fault — the telemetry teardown itself was faulted

Every dump is rate-limited per trigger kind (`cooldown_s`) so a
quarantine flap cannot fill the disk the recorder exists to protect.
Like every other obs write path, a failed dump is counted
(`dump_failures`), never raised.

The port's own copy of `singa_tpu/obs/flightrec.py`, which is JAX-free
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

#: event kinds that fire a dump, mapped to the dump's trigger label
TRIGGER_KINDS = {
    "fleet.rollback": "rollback",
    "fleet.canary_abort": "rollback",
    "fleet.quarantine": "quarantine",
    "stream.resume": "failover",
    # "no capture after warmup" as a monitored invariant: a capture
    # landing in an already-warm scope is an anomaly worth a
    # post-mortem window (what request geometry broke the buckets?)
    "perf.recompile_anomaly": "recompile",
    # a router came back from the dead and replayed its WAL: the
    # recovery evidence (what was journaled, what resumed, what went
    # stale) is exactly what the post-mortem of the crash needs
    "router.recover": "router_restart",
}

#: `serve.shed` events inside the window that constitute a storm
SHED_STORM_N = 16
SHED_STORM_WINDOW_S = 5.0

#: sheds ONE tenant must absorb inside the window for its own storm
#: trigger.  Deliberately below SHED_STORM_N: a tenant's last-N sheds
#: are a subset of history, so with an equal threshold the global
#: window would always trip first and the per-tenant view could never
#: fire.  The per-tenant storm additionally requires DILUTION — other
#: tenants' sheds inside the global window — so a single-tenant burst
#: still reads as the plain `shed_storm` it always was.
SHED_TENANT_STORM_N = 12

#: distinct tenants tracked for the per-tenant storm trigger; excess
#: ids share one "other" window (bounded memory, like singa_tenant_*)
SHED_TENANT_CAP = 64

#: spans pulled from the tracer tail into each dump
DUMP_SPANS = 256


class FlightRecorder:
    """Bounded event ring + trigger-driven dumps; see module
    docstring.  `observe(kind, fields)` is the per-event hot path
    (one lock + deque append + a set lookup); `trigger(why)` forces
    a dump — the `obs.flush` fault path uses it directly."""

    def __init__(self, out_dir: str, ring: int = 512,
                 cooldown_s: float = 5.0, extra_fn=None):
        self.out_dir = out_dir
        self.cooldown_s = max(float(cooldown_s), 0.0)
        # optional () -> dict merged into each dump under "perf" —
        # Observability wires the perf watch's watermark/readiness
        # snapshot here so memory state rides along with the evidence
        self.extra_fn = extra_fn
        self.dumps = 0
        self.dump_failures = 0
        self.sheds_seen = 0
        self._ring: deque = deque(maxlen=max(int(ring), 16))
        self._shed_ts: deque = deque(maxlen=SHED_STORM_N)
        # per-tenant shed windows: one tenant's storm is ITS incident
        # (tenant_shed_storm) even when the global rate stays calm —
        # the blast-radius view of the same signal
        self._shed_ts_by_tenant: Dict[str, deque] = {}
        self._last_dump: Dict[str, float] = {}
        self._seq = itertools.count(1)
        self._lock = threading.Lock()

    def observe(self, kind: str, fields: Dict[str, Any],
                tracer=None) -> Optional[str]:
        """Record one event; dump if it is (or completes) a trigger.
        Returns the dump path when one was written."""
        try:
            rec = {"ts": round(time.time(), 6), "kind": kind}
            for k, v in fields.items():
                rec[k] = v if isinstance(v, (int, float, str, bool,
                                             type(None))) else str(v)
            with self._lock:
                self._ring.append(rec)
            why = TRIGGER_KINDS.get(kind)
            if why is None and kind == "serve.shed":
                why = self._observe_shed(
                    str(fields.get("tenant") or "default"))
            if why is None and str(
                    fields.get("verdict", fields.get("status", ""))
                    ).upper() == "DIVERGED":
                why = "divergence"
            if why is not None:
                return self.trigger(why, tracer=tracer)
            return None
        except Exception:  # noqa: BLE001 — telemetry never kills work
            self.dump_failures += 1
            return None

    def _observe_shed(self, tenant: str = "default") -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            self.sheds_seen += 1
            self._shed_ts.append((now, tenant))
            full = len(self._shed_ts) == self._shed_ts.maxlen
            stormy = (full and now - self._shed_ts[0][0]
                      <= SHED_STORM_WINDOW_S)
            tw = self._shed_ts_by_tenant.get(tenant)
            if tw is None:
                if len(self._shed_ts_by_tenant) >= SHED_TENANT_CAP:
                    tenant = "other"
                tw = self._shed_ts_by_tenant.setdefault(
                    tenant, deque(maxlen=SHED_TENANT_STORM_N))
            tw.append(now)
            # diluted: the global window carries OTHER tenants' sheds
            # too, so the fleet-wide counter under-reads this tenant's
            # burst — exactly the blind spot the per-tenant view fills
            t_stormy = (len(tw) == tw.maxlen
                        and now - tw[0] <= SHED_STORM_WINDOW_S
                        and any(tn != tenant
                                for _, tn in self._shed_ts))
        if stormy:
            return "shed_storm"
        # the fleet-wide storm wins (it subsumes the tenant view)
        return "tenant_shed_storm" if t_stormy else None

    def trigger(self, why: str, tracer=None,
                **context) -> Optional[str]:
        """Dump the ring (rate-limited per `why`).  Returns the path
        written, or None (cooldown / failure — counted, not raised)."""
        try:
            now = time.monotonic()
            with self._lock:
                last = self._last_dump.get(why)
                if last is not None and now - last < self.cooldown_s:
                    return None
                self._last_dump[why] = now
                events = list(self._ring)
                seq = next(self._seq)
            spans = []
            if tracer is not None:
                spans = tracer.events()[-DUMP_SPANS:]
            dump = {"trigger": why, "wall_ts": round(time.time(), 6),
                    "pid": os.getpid(),
                    "process": getattr(tracer, "process", None),
                    "context": context,
                    "events": events, "spans": spans}
            if self.extra_fn is not None:
                try:
                    dump["perf"] = self.extra_fn()
                except Exception:  # noqa: BLE001 — evidence is
                    pass           # best-effort, never a new failure
            os.makedirs(self.out_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in why)
            path = os.path.join(self.out_dir,
                                f"flightrec-{safe}-{seq}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dump, f, default=str)
            os.replace(tmp, path)
            self.dumps += 1
            return path
        except Exception:  # noqa: BLE001
            self.dump_failures += 1
            return None
