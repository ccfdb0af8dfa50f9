"""Numeric-health sentinel of the training runtime.

The port's own copy of `singa_tpu/utils/health.py`:

- **Device-side probes** (`health_probes`): the global gradient norm,
  the post-update parameter norm and the update ratio ||Δp||/||p||,
  computed on the device inside the train step (eager or a CUDA-graph
  replay) and returned with its metrics, so they reach the host only
  when the trainer drains a chunk's metrics: no extra host sync.
- **Host-side classification** (`HealthMonitor`): rolling median/MAD
  windows over loss and grad norm plus EWMA trackers, consulted as the
  metrics drain; each step is OK / SPIKE / NONFINITE / DIVERGED.  Only
  OK values enter the windows, so a poisoned regime never normalizes
  itself.
- **Structured failure** (`NumericDivergence`): raised by the trainer
  on a fatal verdict; carries (step, metric, value, threshold) so the
  Supervisor can roll back past the divergence (checkpoint verdicts are
  recorded in MANIFEST.json; `restore(skip_unhealthy=True)` walks back
  to the last numerically good snapshot) and apply its rescue policy
  (blamed batches, one-shot LR backoff).
- **Sync validation** (`delta_health`): finite/norm check of a
  replica's contribution, for the elastic tier.

Every path is testable on the CPU through the `nan`/`spike` fault kinds
at the `step.grad` site (utils.faults).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

import torch

# verdict statuses, ordered benign -> fatal
OK = "ok"
SPIKE = "spike"
DIVERGED = "diverged"
NONFINITE = "nonfinite"
_SEVERITY = {OK: 0, SPIKE: 1, DIVERGED: 2, NONFINITE: 3}
FATAL = (DIVERGED, NONFINITE)

#: gradient scale applied by the "spike" fault kind (utils.faults) —
#: big enough that any sane MAD window flags it, small enough that the
#: poisoned step stays finite in float32 (the point of `spike` vs `nan`)
SPIKE_SCALE = 1e3

#: metric keys the compiled step contributes (health_probes) — namespaced
#: so they coexist with model metrics in the deferred ring / Performance
GRAD_NORM = "health/grad_norm"
PARAM_NORM = "health/param_norm"
UPDATE_RATIO = "health/update_ratio"


class NumericDivergence(RuntimeError):
    """Training state is numerically poisoned: a probe went non-finite
    or a hard/rolling threshold was breached past patience.  Structured
    so the Supervisor's rescue policy can reason about it."""

    def __init__(self, step: int, metric: Optional[str],
                 value: Optional[float], threshold: Optional[float],
                 status: str = DIVERGED):
        self.step = int(step)
        self.metric = metric
        self.value = value
        self.threshold = threshold
        self.status = status
        thr = (f" (threshold {threshold:.6g})"
               if threshold is not None else "")
        val = f"={value:.6g}" if value is not None else ""
        super().__init__(f"numeric divergence at step {step}: "
                         f"{status} {metric or 'metrics'}{val}{thr}")


@dataclass
class HealthSpec:
    """Thresholds for the monitor plus the Supervisor's rescue policy
    (one spec so `--health_spec` configures the whole tier).

    A cap of 0 disables that check.  `spike_mad` is the MAD-multiple
    deviation from the rolling median that flags a SPIKE; `patience`
    consecutive SPIKEs escalate to DIVERGED."""
    grad_norm_max: float = 1e6      # hard cap -> DIVERGED
    loss_max: float = 0.0           # hard cap on loss (0 = off)
    update_ratio_max: float = 10.0  # hard cap on ||Δp||/||p||
    param_drift_max: float = 0.0    # param_norm vs its EWMA (0 = off)
    spike_mad: float = 10.0         # MAD multiples -> SPIKE
    window: int = 64                # rolling window length
    warmup: int = 8                 # OK observations before MAD tests
    patience: int = 3               # consecutive SPIKEs -> DIVERGED
    ewma_alpha: float = 0.1
    # rescue policy (consumed by the Supervisor via main.py)
    max_divergences: int = 2        # divergence restart budget
    blame_batches: int = 0          # batches skipped at the crash step
    lr_backoff: float = 0.0         # one-shot LR scale on rescue (0=off)

    _INT = ("window", "warmup", "patience", "max_divergences",
            "blame_batches")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "HealthSpec":
        """CLI grammar: comma/semicolon-separated `key=value` entries,
        e.g. `"grad_norm_max=1e4,spike_mad=8,patience=3,lr_backoff=0.5"`.
        Keys are the HealthSpec field names."""
        out = cls()
        if not spec:
            return out
        known = {f.name for f in fields(cls) if not f.name.startswith("_")}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in known:
                raise ValueError(
                    f"bad health spec entry {part!r} (want key=value "
                    f"with key in {sorted(known)})")
            try:
                setattr(out, key, int(val) if key in cls._INT
                        else float(val))
            except ValueError as e:
                raise ValueError(
                    f"bad health spec value for {key!r}: {val!r}") from e
        return out


@dataclass
class Verdict:
    """One step's classification."""
    step: int
    status: str
    metric: Optional[str] = None
    value: Optional[float] = None
    threshold: Optional[float] = None

    @property
    def fatal(self) -> bool:
        return self.status in FATAL

    def to_error(self) -> NumericDivergence:
        return NumericDivergence(self.step, self.metric, self.value,
                                 self.threshold, status=self.status)


# -- device-side probes -----------------------------------------------------
def _sqsum(tensors) -> torch.Tensor:
    """Sum of squares in f32: each leaf's L2 norm, accumulated in f32 by
    one multi-tensor kernel (`torch._foreach_norm`), squared, then
    summed across the leaves, which callers pass in sorted key order (as
    `jax.tree_util` orders dict leaves).  A handful of kernels for any
    number of leaves, where a reduction per leaf would launch dozens in
    every replayed step; the square of the rounded norm is within an
    ulp or two of the leaf's sum of squares."""
    norms = torch._foreach_norm([x.float() for x in tensors])
    return torch.sum(torch.square(torch.stack(norms)))


def health_probes(grads: Dict[str, torch.Tensor],
                  old_params: Dict[str, torch.Tensor],
                  new_params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Numeric probes of one train step, as 0-d f32 device tensors and
    with no host sync: global grad L2 norm, post-update param norm, and
    update ratio ||new - old|| / (||new|| + eps).  `old_params` holds
    the params before the update (the updater writes `new_params` in
    place, so the caller keeps a copy)."""
    names = sorted(new_params)
    new = [new_params[k] for k in names]
    gn = torch.sqrt(_sqsum([grads[k] for k in sorted(grads)]))
    pn = torch.sqrt(_sqsum(new))
    un = torch.sqrt(_sqsum(torch._foreach_sub(
        new, [old_params[k] for k in names])))
    return {GRAD_NORM: gn, PARAM_NORM: pn,
            UPDATE_RATIO: un / (pn + 1e-12)}


@torch.no_grad()
def delta_health(tree: Dict[str, torch.Tensor],
                 ref: Optional[Dict[str, torch.Tensor]] = None,
                 max_norm: float = 0.0) -> tuple[bool, float]:
    """Validate a sync contribution before it touches the center:
    returns (ok, delta_norm).  `ref` defaults to zeros (plain finiteness
    check); `max_norm > 0` additionally caps the delta norm.  One host
    sync: sync rounds are infrequent, so it is off the hot path."""
    names = sorted(tree)
    deltas = [tree[k].float() - (ref[k].float() if ref is not None else 0)
              for k in names]
    if not deltas:
        return True, 0.0
    sq = _sqsum(deltas)
    finite = torch.stack([torch.isfinite(d).all() for d in deltas]).all()
    norm = float(torch.sqrt(sq))
    ok = bool(finite) and math.isfinite(norm)
    if ok and max_norm and max_norm > 0:
        ok = norm <= max_norm
    return ok, norm


# -- host-side monitor ------------------------------------------------------
class HealthMonitor:
    """Classify each step's probe metrics as the deferred ring drains.

    `observe(step, metrics)` returns a `Verdict`; the trainer raises
    `verdict.to_error()` on fatal ones.  `snapshot_health()` /
    `mark_snapshot()` bracket checkpoint saves: the recorded verdict is
    the WORST status since the previous snapshot, so a save taken in a
    suspect window is marked and `restore(skip_unhealthy=True)` can
    walk past it."""

    def __init__(self, spec: Optional[HealthSpec] = None, log_fn=print):
        self.spec = spec or HealthSpec()
        self.log = log_fn
        self.reset()

    def reset(self) -> None:
        """Forget all rolling state (Supervisor calls this per attempt:
        statistics from a poisoned run must not pollute the retry)."""
        w = max(self.spec.window, 4)
        self._windows = {"loss": deque(maxlen=w),
                         "grad_norm": deque(maxlen=w)}
        self._ewma: Dict[str, float] = {}
        self._spike_run = 0
        self.counts: Dict[str, int] = {OK: 0, SPIKE: 0, DIVERGED: 0,
                                       NONFINITE: 0}
        self.last_verdict: Optional[Verdict] = None
        self._since_snapshot = OK
        self._last_vals: Dict[str, float] = {}

    def register_into(self, registry,
                      prefix: str = "singa_health") -> None:
        """Register the verdict tallies into an `obs.MetricsRegistry`
        as a pull-time collector — additive; classification semantics
        and the monitor's own API are untouched.  (Counts reset per
        Supervisor attempt, exactly like `self.counts` always has.)"""
        from ..obs.metrics import Sample

        def collect():
            return [Sample(f"{prefix}_verdict_{status}_total",
                           "counter",
                           f"steps classified {status.upper()} "
                           f"(current attempt)", float(n))
                    for status, n in sorted(self.counts.items())]

        registry.register_collector(collect)

    # -- classification ----------------------------------------------------
    @staticmethod
    def _extract(metrics: Dict[str, Any]) -> Dict[str, float]:
        vals = {}
        for name, key in (("loss", "loss"), ("grad_norm", GRAD_NORM),
                          ("param_norm", PARAM_NORM),
                          ("update_ratio", UPDATE_RATIO)):
            if key in metrics:
                try:
                    vals[name] = float(metrics[key])
                except (TypeError, ValueError):  # pragma: no cover
                    continue
        return vals

    def _mad_spike(self, name: str, v: float):
        """(deviation, threshold) when `v` is a MAD-outlier vs the
        rolling window, else None."""
        win = self._windows[name]
        if len(win) < max(self.spec.warmup, 2):
            return None
        vals = sorted(win)
        n = len(vals)
        med = (vals[n // 2] if n % 2 else
               0.5 * (vals[n // 2 - 1] + vals[n // 2]))
        mad = sorted(abs(x - med) for x in vals)[n // 2]
        # floor the scale: a perfectly flat window (synthetic data,
        # converged loss) must not turn float jitter into spikes
        scale = max(mad, 1e-3 * abs(med), 1e-8)
        thr = self.spec.spike_mad * scale
        dev = abs(v - med)
        return (dev, med + thr if v >= med else med - thr) \
            if dev > thr else None

    def observe(self, step: int, metrics: Dict[str, Any]) -> Verdict:
        vals = self._extract(metrics)
        self._last_vals = dict(vals)
        status, metric, value, threshold = OK, None, None, None

        for name, v in vals.items():
            if not math.isfinite(v):
                status, metric, value = NONFINITE, name, v
                break
        if status == OK:
            for name, cap in (("grad_norm", self.spec.grad_norm_max),
                              ("loss", self.spec.loss_max),
                              ("update_ratio",
                               self.spec.update_ratio_max)):
                if cap and cap > 0 and name in vals and vals[name] > cap:
                    status, metric, value, threshold = \
                        DIVERGED, name, vals[name], cap
                    break
        if status == OK and self.spec.param_drift_max > 0:
            pn, ew = vals.get("param_norm"), self._ewma.get("param_norm")
            if (pn is not None and ew is not None and ew > 0
                    and pn > self.spec.param_drift_max * ew):
                status, metric, value = SPIKE, "param_norm", pn
                threshold = self.spec.param_drift_max * ew
        if status == OK:
            for name in ("grad_norm", "loss"):
                v = vals.get(name)
                hit = self._mad_spike(name, v) if v is not None else None
                if hit is not None:
                    status, metric, value, threshold = \
                        SPIKE, name, v, hit[1]
                    break

        if status == SPIKE:
            self._spike_run += 1
            if (self.spec.patience > 0
                    and self._spike_run >= self.spec.patience):
                status = DIVERGED
        elif status == OK:
            self._spike_run = 0
            for name in ("grad_norm", "loss"):
                if name in vals:
                    self._windows[name].append(vals[name])
            a = self.spec.ewma_alpha
            for name in ("param_norm", "update_ratio"):
                if name in vals:
                    prev = self._ewma.get(name)
                    self._ewma[name] = (vals[name] if prev is None
                                        else (1 - a) * prev
                                        + a * vals[name])

        verdict = Verdict(step, status, metric, value, threshold)
        self.last_verdict = verdict
        self.counts[status] += 1
        if _SEVERITY[status] > _SEVERITY[self._since_snapshot]:
            self._since_snapshot = status
        if status == SPIKE:
            self.log(f"warning: health SPIKE at step {step}: "
                     f"{metric}={value:.6g} vs rolling threshold "
                     f"{threshold:.6g} "
                     f"({self._spike_run}/{self.spec.patience} toward "
                     f"divergence)")
        elif verdict.fatal:
            self.log(f"health: {status.upper()} at step {step}: "
                     f"{metric}={value!r}"
                     + (f" (threshold {threshold:.6g})"
                        if threshold is not None else ""))
        return verdict

    # -- checkpoint bracket -------------------------------------------------
    def snapshot_health(self) -> Dict[str, Any]:
        """Verdict record for the snapshot about to be saved: the worst
        status since the last snapshot plus the final probe values —
        written into the checkpoint MANIFEST so `skip_unhealthy`
        restores can walk past suspect snapshots."""
        rec: Dict[str, Any] = {"verdict": self._since_snapshot}
        for name in ("loss", "grad_norm"):
            if name in self._last_vals:
                v = self._last_vals[name]
                rec[name] = v if math.isfinite(v) else repr(v)
        return rec

    def ok_to_save(self) -> bool:
        """False when the state that would be snapshotted is known
        poisoned — the trainer refuses the save outright (a SPIKE
        window still saves, but marked, so walk-back can skip it)."""
        return self._since_snapshot not in FATAL

    def mark_snapshot(self) -> None:
        self._since_snapshot = OK
