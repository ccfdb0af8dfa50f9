"""Updaters (SGD-family optimizers) + learning-rate schedules.

Port of `singa_tpu/core/updater.py` (SINGA's updater.cc), same formulas
and the same weight-decay placement per type:

- LR schedules: kFixed, kLinear, kExponential, kInverse_t, kInverse,
  kStep (C++ integer division step/freq, a floor), kCosine,
  kWarmupCosine.  Computed on the host in float32, as the JAX package
  computes them on f32 arrays (`step` as f32, `:45`), then written
  to the device by `Updater.set_step`.
- kSGD: wd folded into the grad; history = momentum·history + lr·grad,
  data −= history (or data −= lr·grad without momentum).
- kNesterov: data −= (1+mu)·h_new − mu·h_old.
- kAdaGrad / kRMSProp: history from the grad BEFORE the wd fold.
- kAdaDelta: wd folded first; no lr.
- kAdam: wd folded first; bias corrections 1 − b**(step+1) in float32
  (`:196-198`).
The JAX update's `grad_scale` (SINGA's, which no caller sets to other
than 1) is not carried over.

Params, grads and state are dicts of tensors keyed by param name; the
state is {"history": {...}} plus {"update": {...}} for kAdaDelta and
kAdam, the JAX package's layout, so a checkpoint carries across.  Unlike
the JAX package's pure update, `Updater.update` works IN PLACE, under
`torch.no_grad()`, on the f32 master params and the state tensors: the
trainer holds one copy of each, not two.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config.schema import UpdaterConfig
from ..device import params_device

_F = np.float32


def learning_rate(cfg: UpdaterConfig, step) -> float:
    """GetLearningRate (updater.cc:11-51) in float32 arithmetic."""
    base = _F(cfg.base_learning_rate)
    final = _F(cfg.final_learning_rate)
    freq = _F(cfg.learning_rate_change_frequency)
    # 0.5·(base − final) is a Python-float product in the JAX package too
    half = _F(0.5 * (cfg.base_learning_rate - cfg.final_learning_rate))
    method = cfg.learning_rate_change_method
    step = _F(step)
    if method == "kFixed":
        lr = base
    elif method == "kLinear":
        r = step / freq
        lr = (_F(1) - r) * base + r * final
    elif method == "kExponential":
        lr = base / np.power(_F(2), step / freq)
    elif method == "kInverse_t":
        lr = base / (_F(1) + step / final)
    elif method == "kInverse":
        lr = base * np.power(_F(1) + _F(cfg.gamma) * step, _F(-cfg.pow))
    elif method == "kStep":
        # C++ integer division step/freq (updater.cc:41-45)
        lr = base * np.power(_F(cfg.gamma), np.floor(step / freq))
    elif method == "kCosine":
        t = np.clip(step / _F(max(cfg.learning_rate_change_frequency, 1)),
                    _F(0), _F(1))
        lr = final + half * (_F(1) + np.cos(_F(math.pi) * t))
    elif method == "kWarmupCosine":
        warm = max(cfg.warmup_steps, 1)
        total = max(cfg.learning_rate_change_frequency, warm + 1)
        if step < warm:
            lr = base * (step + _F(1)) / _F(warm)
        else:
            t = np.clip((step - _F(warm)) / _F(total - warm), _F(0), _F(1))
            lr = final + half * (_F(1) + np.cos(_F(math.pi) * t))
    else:
        raise ValueError(f"unknown LR schedule {method!r}")
    return float(_F(lr))


class Multipliers(NamedTuple):
    """Per-param static multipliers (ParamProto lr/wd multipliers)."""
    lr: float = 1.0
    wd: float = 1.0


class Updater:
    """state = self.init(params); self.update(step, grads, params, state)
    updates params and state in place.  `multipliers` maps param name to
    `Multipliers` (default all ones).

    `update` is `set_step` then `apply`.  `set_step` writes every value
    that changes from step to step (the learning rate of each lr
    multiplier, with `lr_scale`; Adam's bias corrections c1 and c2) into
    0-d f32 tensors on the params' device that the updater owns; `apply`
    is the device work alone, which reads them there.  So a CUDA graph
    that captures `apply` once replays any step after a `set_step`.
    `apply` runs one chain of `torch._foreach_*` ops per group of params
    that share their `Multipliers`, with every rounding of the JAX
    formula: no two of its steps are fused into one op that rounds once
    (no addcmul/addcdiv, no `alpha=`), and h / c1 is a true division by
    the device scalar, as JAX divides.  Eager steps, graph replays and
    the CPU all run this one path."""

    def __init__(self, cfg: UpdaterConfig):
        self.cfg = cfg
        self.type = cfg.type
        # the JAX package's rescue-policy LR scale (Trainer.apply_lr_backoff)
        self.lr_scale = 1.0
        # ("lr", multiplier) / "c1" / "c2" -> 0-d f32 tensor on the device
        self._scalars: Dict[Any, torch.Tensor] = {}

    def init(self, params: Dict[str, torch.Tensor]
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        state = {"history": {k: torch.zeros_like(p)
                             for k, p in params.items()}}
        if self.type in ("kAdaDelta", "kAdam"):
            state["update"] = {k: torch.zeros_like(p)
                               for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, step: int, grads: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor],
               state: Dict[str, Dict[str, torch.Tensor]],
               multipliers: Optional[Dict[str, Multipliers]] = None
               ) -> None:
        self.set_step(step, params, multipliers)
        self.apply(grads, params, state, multipliers)

    def _scalar(self, key, device: torch.device) -> torch.Tensor:
        t = self._scalars.get(key)
        if t is None or t.device != device:
            t = self._scalars[key] = torch.zeros((), dtype=torch.float32,
                                                 device=device)
        return t

    @torch.no_grad()
    def set_step(self, step: int, params: Dict[str, torch.Tensor],
                 multipliers: Optional[Dict[str, Multipliers]] = None
                 ) -> None:
        """Write step `step`'s scalars, computed on the host in f32 as the
        JAX package computes them, into the device tensors `apply` reads
        (`fill_`, in stream order after whatever read them last)."""
        cfg = self.cfg
        dev = params_device(params)
        lr = learning_rate(cfg, step) if cfg.base_learning_rate else 0.0
        lr = _F(lr) * _F(self.lr_scale)
        for m in _groups(params, multipliers):
            self._scalar(("lr", m.lr), dev).fill_(float(lr * _F(m.lr)))
        if self.type == "kAdam":
            tstep = _F(step) + _F(1)
            for key, b in (("c1", cfg.beta1), ("c2", cfg.beta2)):
                self._scalar(key, dev).fill_(
                    float(_F(1) - np.power(_F(b), tstep)))

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor],
              state: Dict[str, Dict[str, torch.Tensor]],
              multipliers: Optional[Dict[str, Multipliers]] = None
              ) -> None:
        """The update of the step last given to `set_step`, in place."""
        dev = params_device(params)
        updates = state.get("update")
        for m, names in _groups(params, multipliers).items():
            lr = self._scalars.get(("lr", m.lr))
            if lr is None or lr.device != dev:
                raise RuntimeError(f"Updater.apply before set_step on {dev}")
            self._apply_group(
                [params[k] for k in names], [grads[k] for k in names],
                [state["history"][k] for k in names],
                [updates[k] for k in names] if updates is not None
                else None, lr, self.cfg.weight_decay * m.wd)

    def _apply_group(self, p, g, h, u, lr, wd):
        cfg = self.cfg
        t = self.type
        if t in ("kSGD", "kNesterov", "kAdaDelta", "kAdam") and wd > 0:
            g = _plus_decay(g, p, wd)
        if t == "kSGD":
            step = torch._foreach_mul(g, lr)                   # lr·g
            if cfg.momentum > 0:
                torch._foreach_mul_(h, cfg.momentum)
                torch._foreach_add_(h, step)
                step = h
            torch._foreach_sub_(p, step)
        elif t == "kNesterov":
            old = torch._foreach_mul(h, cfg.momentum)          # h_old·mu
            torch._foreach_mul_(h, cfg.momentum)
            torch._foreach_add_(h, torch._foreach_mul(g, lr))
            step = torch._foreach_mul(h, 1 + cfg.momentum)
            torch._foreach_sub_(step, old)
            torch._foreach_sub_(p, step)
        elif t in ("kAdaGrad", "kRMSProp"):
            sq = torch._foreach_mul(g, g)
            if t == "kRMSProp":
                torch._foreach_mul_(h, cfg.rho)
                torch._foreach_mul_(sq, 1 - cfg.rho)
            torch._foreach_add_(h, sq)
            if wd > 0:
                g = _plus_decay(g, p, wd)
            step = torch._foreach_mul(g, lr)
            den = torch._foreach_add(h, cfg.delta)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(step, den)
            torch._foreach_sub_(p, step)
        elif t == "kAdaDelta":
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1 - cfg.rho)
            torch._foreach_mul_(h, cfg.rho)
            torch._foreach_add_(h, sq)
            num = torch._foreach_add(u, cfg.delta)
            torch._foreach_sqrt_(num)
            step = torch._foreach_mul(g, num)
            den = torch._foreach_add(h, cfg.delta)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(step, den)                     # tmp
            sq = torch._foreach_mul(step, step)
            torch._foreach_mul_(sq, 1 - cfg.rho)
            torch._foreach_mul_(u, cfg.rho)
            torch._foreach_add_(u, sq)
            torch._foreach_sub_(p, step)
        elif t == "kAdam":
            b1, b2 = cfg.beta1, cfg.beta2
            torch._foreach_mul_(h, b1)                         # first moment
            torch._foreach_add_(h, torch._foreach_mul(g, 1 - b1))
            sq = torch._foreach_mul(g, g)                      # second moment
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(u, b2)
            torch._foreach_add_(u, sq)
            step = torch._foreach_div(h, self._scalars["c1"])  # mhat
            den = torch._foreach_div(u, self._scalars["c2"])   # vhat
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.delta)
            torch._foreach_mul_(step, lr)
            torch._foreach_div_(step, den)
            torch._foreach_sub_(p, step)
        else:
            raise ValueError(f"unknown updater type {t!r}")


def _plus_decay(g, p, wd):
    """g + p·wd, rounded after the product and after the sum as JAX
    rounds it; the caller's grads are not written."""
    out = torch._foreach_mul(p, wd)
    torch._foreach_add_(out, g)
    return out


def _groups(params, multipliers) -> Dict[Multipliers, list]:
    """Param names grouped by their `Multipliers`, in params' order."""
    ones = Multipliers()
    groups: Dict[Multipliers, list] = {}
    for name in params:
        m = multipliers.get(name, ones) if multipliers else ones
        groups.setdefault(m, []).append(name)
    return groups


def make_updater(cfg: Optional[UpdaterConfig]) -> Updater:
    return Updater(cfg if cfg is not None else UpdaterConfig(type="kSGD"))
