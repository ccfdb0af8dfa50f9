"""Tenancy: the blast-radius boundary between workloads sharing one
fleet.

The port's own copy of `singa_tpu/serve/tenancy.py` (JAX-free there
too).

The serving tier's earlier protections were fleet-global — RetryBudget,
brownout fractions, Retry-After streaks, shed accounting, autoscaler
signals — so the first flash crowd from one workload degraded
*everyone*: a single misbehaving client could drain the shared retry
budget and starve interactive traffic it never touched.  This module
makes the tenant the unit of isolation (the serving analog of the
multi-workload argument in "TensorFlow: A system for large-scale
machine learning", arxiv 1605.08695):

  `TenantSpec`      one tenant's QoS envelope: a guaranteed retry-
                    budget floor, queue/slot/KV-block quota fractions,
                    and optional brownout-fraction overrides.
  `TenantBudget`    a per-tenant child of the global `qos.RetryBudget`:
                    spends draw the tenant's private floor bucket
                    FIRST, then the shared bucket — so one tenant's
                    straggler storm can exhaust the shared tokens but
                    never another tenant's floor.  Earns refill the
                    private floor first; overflow earns into the
                    shared bucket, so the total-inflow arithmetic of
                    the global budget is preserved.
  `TenantRegistry`  the configured tenant set.  `default` is the
                    legacy tenant (no `X-Tenant` header) and always
                    exists; every UNCONFIGURED tenant id folds into
                    one shared `other` envelope — bounded memory,
                    bounded metric label cardinality (a tenant-id
                    fuzzer pays into `other`, it cannot blow up
                    `/metrics` or starve `default`), and an honest
                    rule: isolation is something you configure, not
                    something a header invents.

Spec grammar (`--tenant_spec`): tenants separated by `;`, fields by
`,`, the first field the tenant name, the rest `key=value` floats:

    "a,queue_frac=0.25,budget_floor=4;b,queue_frac=0.5"

`other` may be configured explicitly to clamp what unconfigured ids
collectively get.  Unknown keys and malformed entries raise (the CLI's
fail-fast contract); unknown tenant IDS at request time never do —
see `qos.check_tenant`.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

from . import qos

#: the fold target for every unconfigured tenant id
TENANT_OTHER = "other"
#: the legacy tenant (requests without an X-Tenant header)
TENANT_DEFAULT = "default"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS envelope.  Fractions are shares of the
    enforcing component's capacity (queue depth, cb slots, KV pool
    blocks); 1.0 = no quota.  `budget_floor` is the guaranteed
    retry/hedge token floor (0 = no floor: pure shared-bucket
    behavior, what `default` gets unless configured).  Brownout
    overrides of 0.0 inherit the engine's fractions."""
    name: str
    budget_floor: float = 2.0
    queue_frac: float = 1.0
    slot_frac: float = 1.0
    kv_frac: float = 1.0
    brownout_be_frac: float = 0.0     # 0 = inherit ServeSpec
    brownout_batch_frac: float = 0.0  # 0 = inherit ServeSpec

    def __post_init__(self):
        name = str(self.name)
        if not name or name != qos.check_tenant(name):
            raise ValueError(
                f"bad tenant name {self.name!r}: want 1-64 chars of "
                f"[a-z0-9_-]")
        if float(self.budget_floor) < 0:
            raise ValueError(f"tenant {name}: budget_floor must be "
                             f">= 0, got {self.budget_floor}")
        for field in ("queue_frac", "slot_frac", "kv_frac"):
            v = float(getattr(self, field))
            if not 0 < v <= 1:
                raise ValueError(f"tenant {name}: {field} must be in "
                                 f"(0, 1], got {v}")
        for field in ("brownout_be_frac", "brownout_batch_frac"):
            v = float(getattr(self, field))
            if not 0 <= v <= 1:
                raise ValueError(f"tenant {name}: {field} must be in "
                                 f"[0, 1] (0 = inherit), got {v}")


class TenantBudget:
    """Per-tenant view of the global `qos.RetryBudget` with a
    guaranteed floor.  The private floor bucket starts full (mirroring
    RetryBudget's burst) and refills ONLY from this tenant's own
    earns, so another tenant's retry storm — which drains the shared
    bucket — leaves this tenant's floor tokens untouched.  A zero
    floor degenerates to the shared bucket exactly (the legacy
    single-tenant arithmetic)."""

    def __init__(self, shared: qos.RetryBudget, floor: float = 0.0):
        self.shared = shared
        self.floor = max(float(floor), 0.0)
        self._tokens = self.floor
        self._lock = threading.Lock()

    def earn(self, n: int = 1) -> None:
        """One primary dispatch: top up the private floor first;
        whatever does not fit earns into the shared bucket (same
        ratio), keeping total inflow identical to the pre-tenancy
        global bucket."""
        add = self.shared.ratio * n
        with self._lock:
            take = min(add, max(self.floor - self._tokens, 0.0))
            self._tokens += take
        rem = add - take
        if rem > 0 and self.shared.ratio > 0:
            self.shared.earn(rem / self.shared.ratio)

    def spend(self, n: float = 1.0) -> bool:
        """One retry/hedge/resume: the private floor pays first, then
        the shared bucket."""
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                return True
        return self.shared.spend(n)

    def refund(self, n: float = 1.0) -> None:
        """Reverse of spend for a dispatch that never happened: refill
        the floor first, overflow back to the shared bucket."""
        with self._lock:
            take = min(n, max(self.floor - self._tokens, 0.0))
            self._tokens += take
        rem = n - take
        if rem > 0:
            self.shared.refund(rem)

    def tokens(self) -> float:
        """Floor tokens only (the shared bucket reports its own)."""
        with self._lock:
            return self._tokens


class TenantRegistry:
    """The configured tenant set and its per-tenant envelopes.  All
    lookups are by FOLDED label: a configured name (always including
    `default`) maps to itself, everything else to `other` — the one
    rule that bounds memory, metric cardinality, and blast radius at
    the same time."""

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        for spec in specs:
            if spec.name in self._specs:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self._specs[spec.name] = spec
        # default + other always exist; unconfigured = no floor, no
        # quota — exact legacy behavior for legacy clients
        for name in (TENANT_DEFAULT, TENANT_OTHER):
            self._specs.setdefault(
                name, TenantSpec(name=name, budget_floor=0.0))
        self._budgets: Dict[str, TenantBudget] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: Optional[str]) -> "TenantRegistry":
        """`"a,queue_frac=0.25,budget_floor=4;b,queue_frac=0.5"` —
        see the module docstring."""
        specs = []
        fields = {f.name for f in dataclasses.fields(TenantSpec)
                  if f.name != "name"}
        for entry in (spec or "").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = [p.strip() for p in entry.split(",") if p.strip()]
            name, kw = parts[0], {}
            for part in parts[1:]:
                key, sep, val = part.partition("=")
                key, val = key.strip(), val.strip()
                if not sep or key not in fields:
                    raise ValueError(
                        f"bad tenant spec entry {part!r} for tenant "
                        f"{name!r} (want key=value with keys "
                        f"{sorted(fields)})")
                try:
                    kw[key] = float(val)
                except ValueError as e:
                    raise ValueError(
                        f"bad tenant spec value {part!r} for tenant "
                        f"{name!r}: {e}") from e
            specs.append(TenantSpec(name=name, **kw))
        return cls(specs)

    # -- lookups (all label-folded) -----------------------------------------
    def label(self, tenant: Optional[str]) -> str:
        """Fold a raw tenant id into its accounting/metrics label:
        configured names map to themselves, everything else to
        `other`."""
        t = qos.check_tenant(tenant)
        return t if t in self._specs else TENANT_OTHER

    def spec_for(self, tenant: Optional[str]) -> TenantSpec:
        return self._specs[self.label(tenant)]

    def labels(self) -> Tuple[str, ...]:
        """Every label that can appear on a `singa_tenant_*` series —
        the configured set; the bound the cardinality tests assert."""
        return tuple(sorted(self._specs))

    def names(self) -> Tuple[str, ...]:
        return self.labels()

    # -- budgets ------------------------------------------------------------
    def bind_budgets(self, shared: qos.RetryBudget) -> None:
        """Attach per-tenant child budgets to the shared bucket (the
        Router calls this once at construction)."""
        with self._lock:
            self._budgets = {
                name: TenantBudget(shared, spec.budget_floor)
                for name, spec in self._specs.items()}

    def budget(self, tenant: Optional[str]) -> TenantBudget:
        """The requesting tenant's budget view (label-folded).  Raises
        if `bind_budgets` was never called — budgets have no meaning
        without a shared bucket to draw from."""
        with self._lock:
            if not self._budgets:
                raise RuntimeError("TenantRegistry.bind_budgets() was "
                                   "never called")
            return self._budgets[self.label(tenant)]

    # -- quota arithmetic ---------------------------------------------------
    def queue_quota(self, tenant: Optional[str],
                    capacity: int) -> int:
        """Queued-request quota for one tenant against a queue of
        `capacity` (>= 1 so a quota can never starve a tenant of its
        last slot)."""
        frac = self.spec_for(tenant).queue_frac
        return max(int(frac * int(capacity)), 1)

    def slot_quota(self, tenant: Optional[str], slots: int) -> int:
        frac = self.spec_for(tenant).slot_frac
        return max(int(frac * int(slots)), 1)

    def kv_quota(self, tenant: Optional[str], blocks: int) -> int:
        frac = self.spec_for(tenant).kv_frac
        return max(int(frac * int(blocks)), 1)

    def brownout_fracs(self, tenant: Optional[str],
                       be_frac: float, batch_frac: float):
        """(be_frac, batch_frac) for one tenant: the tenant's
        overrides where configured (> 0), the engine's defaults
        otherwise."""
        spec = self.spec_for(tenant)
        be = spec.brownout_be_frac or float(be_frac)
        batch = spec.brownout_batch_frac or float(batch_frac)
        return be, batch

    def share(self, tenant: Optional[str]) -> float:
        """The tenant's quota share for capacity-signal weighting
        (autoscaler): a tenant limited to a fraction of the queue
        browning out its own overflow is the quota system working,
        not a reason to buy capacity — its sheds count at its
        share."""
        return float(self.spec_for(tenant).queue_frac)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            budgets = dict(self._budgets)
        for name, spec in sorted(self._specs.items()):
            row = {k: float(getattr(spec, k))
                   for k in ("budget_floor", "queue_frac", "slot_frac",
                             "kv_frac")}
            b = budgets.get(name)
            if b is not None:
                row["floor_tokens"] = round(b.tokens(), 3)
            out[name] = row
        return out


class TenantCounts:
    """Bounded per-(tenant, field) counters plus per-tenant latency
    reservoirs — the accounting both `RouterStats` and `ServeStats`
    export as labeled `singa_tenant_*` series.  Keys are folded labels
    (callers fold through a registry); a hard `max_tenants` cap folds
    anything beyond it into `other` anyway, so even an unfolded caller
    cannot grow this without bound.  The accounting identity the
    cardinality tests assert: for any field, the sum over tenant
    labels equals the number of `count` calls — nothing is dropped on
    fold, it lands in `other`."""

    def __init__(self, fields: Tuple[str, ...],
                 max_tenants: int = 64, window: int = 2048):
        self.fields = tuple(fields)
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        self._counts: Dict[str, Dict[str, int]] = {}
        self._lat: Dict[str, list] = {}
        self._window = int(window)

    def _fold(self, tenant: str) -> str:
        if tenant in self._counts or tenant in self._lat:
            return tenant
        n = len(set(self._counts) | set(self._lat))
        # reserve one slot for the overflow bucket so the bound is
        # exact: at most `max_tenants` labels INCLUDING `other`
        if tenant != TENANT_OTHER and n >= self.max_tenants - 1:
            return TENANT_OTHER
        return tenant

    def count(self, field: str, tenant: str, n: int = 1) -> None:
        if field not in self.fields:
            raise ValueError(f"unknown tenant counter {field!r}")
        with self._lock:
            label = self._fold(tenant)
            row = self._counts.setdefault(label, {})
            row[field] = row.get(field, 0) + n

    def observe_latency(self, seconds: float, tenant: str) -> None:
        with self._lock:
            label = self._fold(tenant)
            lat = self._lat.setdefault(label, [])
            lat.append(float(seconds))
            if len(lat) > self._window:
                del lat[:len(lat) - self._window]

    def p95_ms(self, tenant: str) -> Optional[float]:
        with self._lock:
            lat = sorted(self._lat.get(tenant, ()))
        if not lat:
            return None
        idx = min(int(0.95 * len(lat)), len(lat) - 1)
        return round(lat[idx] * 1e3, 3)

    def tenants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(set(self._counts) | set(self._lat)))

    def get(self, field: str, tenant: str) -> int:
        with self._lock:
            return self._counts.get(tenant, {}).get(field, 0)

    def totals(self) -> Dict[str, int]:
        """Per-field totals across every tenant label — the right side
        of the accounting identity."""
        out = {f: 0 for f in self.fields}
        with self._lock:
            for row in self._counts.values():
                for field, n in row.items():
                    out[field] += n
        return out

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            tenants = tuple(sorted(set(self._counts) | set(self._lat)))
        out = {}
        for t in tenants:
            with self._lock:
                row = dict(self._counts.get(t, {}))
            row["p95_ms"] = self.p95_ms(t)
            out[t] = row
        return out

    def register_into(self, registry,
                      prefix: str = "singa_tenant") -> None:
        """Labeled `singa_tenant_*` series: one sample per (field,
        tenant label) plus a per-tenant p95 gauge.  Cardinality is
        bounded by construction — `max_tenants` labels at most."""
        from ..obs.metrics import Sample

        def collect():
            out = []
            for t in self.tenants():
                labels = (("tenant", t),)
                with self._lock:
                    row = dict(self._counts.get(t, {}))
                for field in self.fields:
                    out.append(Sample(
                        f"{prefix}_{field}_total", "counter",
                        f"per-tenant counter {field!r}",
                        float(row.get(field, 0)), labels))
                p95 = self.p95_ms(t)
                if p95 is not None:
                    out.append(Sample(
                        f"{prefix}_p95_ms", "gauge",
                        "per-tenant p95 latency (ms)", p95, labels))
            return out

        registry.register_collector(collect)
