"""Request-lifecycle QoS primitives shared across the serving stack:
priority classes, end-to-end deadlines, the global retry budget, and
per-class shed backoffs.

The port's own copy of `singa_tpu/serve/qos.py`, which is JAX-free.

Deadlines ("RPC Considered Harmful", arxiv 1805.08430): a client
timeout re-invented at every hop lets a request burn the full budget
per hop — four 5s hops serve a client who gave up 15s ago.  Here the
deadline is ONE absolute instant carried on the request: in-process as
a `time.monotonic()` value, across HTTP as the *remaining* budget in
milliseconds (`X-Deadline-Ms` — monotonic clocks are not comparable
across processes, so the receiver re-anchors remaining-ms onto its own
clock, the gRPC convention).  Every hop admits against what is LEFT;
an engine never prefills a request that is already dead on arrival
(counted `expired_on_arrival`), and a router retry can never outlive
the client's deadline.

Priority classes: `interactive` (a user is watching), `batch`
(pipelines; minutes of slack), `best_effort` (scavenger load).  Under
pressure admission sheds lowest class first — brownout — with an
honest per-class Retry-After: lower classes start (and cap) higher, so
the backoff hints themselves push background load out of the way of
interactive traffic.

Retry budget ("The Tail at Scale"): unbounded per-request retries turn
a brownout into a retry storm exactly when capacity is lowest.  The
`RetryBudget` token bucket earns a fraction of a token per PRIMARY
dispatch and spends one per retry or hedge, so fleet-wide retry
amplification is arithmetically capped at (1 + ratio) regardless of
failure pattern.  Exhaustion degrades to single-shot dispatch — the
request's first outcome stands; it is never shed *because* the budget
ran dry.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils import faults

PRIORITIES = ("interactive", "batch", "best_effort")

#: HTTP header carrying the remaining deadline budget in milliseconds
#: (re-anchored onto the receiver's monotonic clock)
DEADLINE_HEADER = "X-Deadline-Ms"
PRIORITY_HEADER = "X-Priority"

#: Tenant id header (serve/tenancy.py).  Degrade-never-reject: a
#: missing/blank/oversized/garbled value falls back to the `default`
#: tenant — tenancy is an isolation boundary, not an auth gate, and a
#: bad tenant header must never 400 a request
TENANT_HEADER = "X-Tenant"

#: W3C-traceparent-style trace context pair: the trace id is minted
#: once at the request's root span and carried VERBATIM on every hop
#: (frontend → router → worker, hedge legs, failover resumes,
#: /admin/reload); the parent span id lets the receiver anchor its
#: own spans under the caller's, so a merged trace reads as one tree
TRACE_HEADER = "X-Trace-Id"
PARENT_SPAN_HEADER = "X-Parent-Span"

#: Durable stream identity (serve/sessionlog.py): the sid is minted
#: at stream open, returned in the FIRST ndjson event (and this
#: response header), and presented back by a reconnecting client to
#: attach to the journaled continuation exactly-once after a router
#: crash or handoff
SESSION_HEADER = "X-Session-Id"

#: The serving router's fencing epoch, echoed on every response: a
#: client (or standby) seeing the epoch move knows a
#: restart/handoff happened even before any stream breaks
EPOCH_HEADER = "X-Router-Epoch"

#: Retry-After escalation factor per class: lower classes are told to
#: stay away longer, so honest hints do the brownout's first pass
_CLASS_FACTORS = (("interactive", 1.0), ("batch", 2.0),
                  ("best_effort", 4.0))


def check_priority(priority: Optional[str]) -> str:
    """Normalize and validate a priority class (None = interactive).
    Raises ValueError (the HTTP layer's 400) on an unknown class."""
    if priority is None:
        return "interactive"
    p = str(priority).strip().lower()
    if p not in PRIORITIES:
        raise ValueError(f"unknown priority {priority!r}; classes are "
                         f"{PRIORITIES}")
    return p


def check_tenant(tenant: Optional[str]) -> str:
    """Normalize a tenant id (None/blank = the `default` tenant).
    NEVER raises: an unparseable or hostile tenant id degrades to a
    sanitized string — quota lookup folds unknown ids into the shared
    `other` envelope, so garbage in the header costs the sender, not
    the request.  Ids are trimmed, lowercased, and truncated to 64
    chars; characters outside [a-z0-9_-] become `_`."""
    if tenant is None:
        return "default"
    t = str(tenant).strip().lower()[:64]
    if not t:
        return "default"
    return "".join(c if (c.isalnum() and c.isascii()) or c in "_-"
                   else "_" for c in t)


def resolve_deadline(timeout: Optional[float],
                     deadline: Optional[float],
                     default_timeout_s: float) -> Optional[float]:
    """The request's ONE absolute monotonic deadline: an explicit
    `deadline` wins; otherwise derived from `timeout` (default
    `default_timeout_s`; <= 0 = no deadline)."""
    if deadline is not None:
        return float(deadline)
    t = default_timeout_s if timeout is None else float(timeout)
    return (time.monotonic() + t) if t and t > 0 else None


def remaining_s(deadline: Optional[float]) -> Optional[float]:
    """Seconds of budget left (may be <= 0: dead on arrival)."""
    if deadline is None:
        return None
    return deadline - time.monotonic()


def transport_budget(deadline: Optional[float],
                     timeout: Optional[float],
                     default_s: float,
                     slack_s: float = 30.0) -> float:
    """Socket/wait budget for one transport hop: base time plus
    dispatch slack.  With an end-to-end deadline the slack is CLAMPED
    to the remaining budget (floor 0.1 s) — a flat `+ 30.0` would let
    a socket outlive a 2 s client deadline by 30 s, holding the
    connection (and the engine slot behind it) long after the client
    gave up.  Without a deadline the old generous slack stands: there
    is no client budget to leak past."""
    rem = remaining_s(deadline)
    if rem is not None:
        base = max(rem, 0.1)
        return base + min(float(slack_s), base)
    base = timeout if timeout and timeout > 0 else default_s
    return max(float(base), 0.1) + float(slack_s)


def deadline_to_header(deadline: Optional[float]) -> Optional[str]:
    """Remaining-budget milliseconds for `X-Deadline-Ms` (floored at 0
    so a dead request still propagates as dead, not as no-deadline)."""
    rem = remaining_s(deadline)
    if rem is None:
        return None
    return str(max(int(rem * 1000), 0))


def trace_to_headers(ctx) -> dict:
    """Serialize an `obs.trace_context()` tuple — `(trace_id,
    span_id)` — into the trace header pair ({} when there is no open
    span / no session: tracing off must add zero bytes to the wire)."""
    if not ctx:
        return {}
    trace_id, span_id = ctx
    out = {}
    if trace_id:
        out[TRACE_HEADER] = str(trace_id)
        if span_id:
            out[PARENT_SPAN_HEADER] = str(span_id)
    return out


def trace_from_headers(trace_id: Optional[str],
                       parent_span: Optional[str]):
    """Parse the receive side back into `(trace_id, parent_span_id)`,
    or None when no trace id was sent.  A malformed parent span id
    degrades to 0 (root of a remote track) — a trace header must
    never 400 a request that telemetry merely rides along on."""
    if trace_id is None or not str(trace_id).strip():
        return None
    try:
        psid = int(str(parent_span).strip()) if parent_span else 0
    except (TypeError, ValueError):
        psid = 0
    return (str(trace_id).strip(), psid)


def deadline_from_header(value: Optional[str]) -> Optional[float]:
    """Re-anchor a remaining-ms header onto THIS process's monotonic
    clock (monotonic instants are not comparable across processes)."""
    if value is None or str(value).strip() == "":
        return None
    return time.monotonic() + float(value) / 1000.0


# -- header <-> binary-frame mapping (serve/wire.py) -------------------------
# The binary transport carries the SAME QoS envelope as the HTTP
# headers, as flat struct fields instead of strings: remaining-ms
# deadline (i64, -1 = none, re-anchored by the receiver exactly like
# X-Deadline-Ms), a u8 priority code, and the tenant/trace/session ids
# as length-prefixed strings.  These helpers are the single source of
# truth for both directions so the two wire surfaces can never drift.

#: u8 priority code meaning "unspecified" (receiver defaults to
#: interactive, matching a missing X-Priority header)
PRIORITY_NONE_CODE = 255


def priority_to_code(priority: Optional[str]) -> int:
    """Priority class -> u8 frame code (index into PRIORITIES;
    PRIORITY_NONE_CODE for None).  Raises ValueError on an unknown
    class, same as check_priority."""
    if priority is None:
        return PRIORITY_NONE_CODE
    return PRIORITIES.index(check_priority(priority))


def priority_from_code(code: int) -> Optional[str]:
    """u8 frame code -> priority class (None for PRIORITY_NONE_CODE).
    An out-of-range code raises ValueError — unlike a garbled tenant,
    a bad priority code means the frame itself is skewed (the codec
    maps it to a malformed-frame close, the binary twin of the 400)."""
    c = int(code)
    if c == PRIORITY_NONE_CODE:
        return None
    if not 0 <= c < len(PRIORITIES):
        raise ValueError(f"unknown priority code {c}")
    return PRIORITIES[c]


def deadline_to_ms(deadline: Optional[float]) -> int:
    """Remaining-budget milliseconds for the frame header (-1 = no
    deadline; floored at 0 so a dead request propagates as dead —
    the flat-struct twin of deadline_to_header)."""
    rem = remaining_s(deadline)
    if rem is None:
        return -1
    return max(int(rem * 1000), 0)


def deadline_from_ms(ms: int) -> Optional[float]:
    """Re-anchor a remaining-ms frame field onto THIS process's
    monotonic clock (the frame twin of deadline_from_header)."""
    m = int(ms)
    if m < 0:
        return None
    return time.monotonic() + m / 1000.0


class RetryBudget:
    """Global token bucket bounding retries + hedges to a fraction of
    primary traffic.  `earn()` once per primary dispatch adds `ratio`
    tokens (capped at `burst`); `spend()` takes one whole token per
    retry/hedge or answers False.  With ratio r, total dispatches can
    never exceed (1 + r) x primaries + burst — a retry storm is
    arithmetically impossible, not merely discouraged."""

    def __init__(self, ratio: float = 0.1, burst: float = 16.0):
        self.ratio = max(float(ratio), 0.0)
        self.burst = max(float(burst), 0.0)
        self._tokens = self.burst
        self._lock = threading.Lock()

    def earn(self, n: int = 1) -> None:
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + self.ratio * n)

    def spend(self, n: float = 1.0) -> bool:
        with self._lock:
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    def refund(self, n: float = 1.0) -> None:
        """Return a token whose dispatch never happened (no sibling
        engine, hedge fault) — spend/refund stays conservative."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class ClassBackoffs:
    """Per-(tenant, priority-class) shed Retry-After: each stream
    escalates over ITS consecutive sheds and resets on ITS next
    successful admission, with lower classes starting (and capping)
    `_CLASS_FACTORS` higher.  Streaks are scoped per TENANT as well as
    per class: before tenancy, any successful dispatch reset the
    escalation streak for everyone, so a busy tenant's completions
    masked another tenant's congestion and its Retry-After never
    escalated.  The `default` tenant's interactive stream reproduces
    the single-class Backoff the admission paths used before
    priorities existed.

    Distinct tenant keys are bounded (`max_tenants`): callers normally
    pass registry-folded labels, but a raw-id caller cannot grow this
    dict without bound either — overflow tenants share the `other`
    stream."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 seed: int = 0, max_tenants: int = 64):
        self._lock = threading.Lock()
        self._base, self._cap, self._seed = base, cap, seed
        self.max_tenants = int(max_tenants)
        self._backoffs = {}
        self._streaks = {}
        self._tenants = set()
        for pri, _ in _CLASS_FACTORS:
            self._ensure("default", pri)

    def _factor(self, priority: str) -> float:
        for pri, factor in _CLASS_FACTORS:
            if pri == priority:
                return factor
        return 1.0

    def _key(self, tenant: str, priority: str):
        """Fold an unseen tenant into `other` once the bound is hit
        (lock held by caller)."""
        if tenant not in self._tenants:
            if len(self._tenants) >= self.max_tenants:
                tenant = "other"
            self._tenants.add(tenant)
        return (tenant, priority)

    def _ensure(self, tenant: str, priority: str):
        key = self._key(tenant, priority)
        if key not in self._backoffs:
            i = len(self._backoffs)
            f = self._factor(priority)
            self._backoffs[key] = faults.Backoff(
                base=self._base * f, cap=self._cap * f,
                seed=self._seed + i)
            self._streaks[key] = 0
        return key

    def shed_delay(self, priority: str,
                   tenant: str = "default") -> float:
        """Record one shed of (tenant, priority); the Retry-After to
        hint."""
        with self._lock:
            key = self._ensure(tenant, priority)
            self._streaks[key] += 1
            attempt = self._streaks[key]
            backoff = self._backoffs[key]
        return backoff.delay(attempt - 1)

    def reset(self, priority: str, tenant: str = "default") -> None:
        """A successful admission of (tenant, priority) ends its
        streak — and ONLY its streak: another tenant's congestion
        keeps escalating."""
        with self._lock:
            key = self._ensure(tenant, priority)
            self._streaks[key] = 0

    def streak(self, priority: str, tenant: str = "default") -> int:
        with self._lock:
            key = self._ensure(tenant, priority)
            return self._streaks[key]

    def export_streaks(self) -> dict:
        """Nonzero streaks as a JSON-safe dict (control-state
        snapshot): a tenant mid-escalation must NOT get a fresh
        Retry-After ladder just because the router restarted."""
        with self._lock:
            return {f"{t}\t{p}": s
                    for (t, p), s in self._streaks.items() if s}

    def restore_streaks(self, streaks: dict) -> None:
        with self._lock:
            for key, s in (streaks or {}).items():
                tenant, _, priority = str(key).partition("\t")
                try:
                    n = max(int(s), 0)
                except (TypeError, ValueError):
                    continue
                if not priority:
                    continue
                k = self._ensure(tenant, priority)
                self._streaks[k] = n
