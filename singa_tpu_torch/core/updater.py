"""Updaters (SGD-family optimizers) + learning-rate schedules.

Port of `singa_tpu/core/updater.py` (SINGA's updater.cc), same formulas
and the same weight-decay placement per type:

- LR schedules: kFixed, kLinear, kExponential, kInverse_t, kInverse,
  kStep (C++ integer division step/freq, a floor), kCosine,
  kWarmupCosine.  Computed on the host in float32, as the JAX package
  computes them on f32 arrays (`step` as f32, `:45`).
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
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config.schema import UpdaterConfig

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
    `Multipliers` (default all ones)."""

    def __init__(self, cfg: UpdaterConfig):
        self.cfg = cfg
        self.type = cfg.type
        # the JAX package's rescue-policy LR scale (Trainer.apply_lr_backoff)
        self.lr_scale = 1.0

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
        cfg = self.cfg
        lr = learning_rate(cfg, step) if cfg.base_learning_rate else 0.0
        lr = float(_F(lr) * _F(self.lr_scale))
        ones = Multipliers()
        updates = state.get("update", {})
        for name, p in params.items():
            m = multipliers.get(name, ones) if multipliers else ones
            self._apply_one(step, p, grads[name], state["history"][name],
                            updates.get(name), float(_F(lr) * _F(m.lr)),
                            cfg.weight_decay * m.wd)

    def _apply_one(self, step, p, g, h, u, lr, wd):
        cfg = self.cfg
        t = self.type
        if t in ("kSGD", "kNesterov", "kAdaDelta", "kAdam") and wd > 0:
            g = g + p * wd
        if t == "kSGD":
            if cfg.momentum > 0:
                h.mul_(cfg.momentum).add_(lr * g)
                p.sub_(h)
            else:
                p.sub_(lr * g)
        elif t == "kNesterov":
            h_old = h.clone()
            h.mul_(cfg.momentum).add_(lr * g)
            p.sub_(h * (1 + cfg.momentum) - h_old * cfg.momentum)
        elif t in ("kAdaGrad", "kRMSProp"):
            sq = torch.square(g)
            if t == "kAdaGrad":
                h.add_(sq)
            else:
                h.mul_(cfg.rho).add_((1 - cfg.rho) * sq)
            if wd > 0:
                g = g + p * wd
            p.sub_(lr * g / torch.sqrt(h + cfg.delta))
        elif t == "kAdaDelta":
            h.mul_(cfg.rho).add_((1 - cfg.rho) * torch.square(g))
            tmp = g * torch.sqrt(u + cfg.delta) / torch.sqrt(h + cfg.delta)
            u.mul_(cfg.rho).add_((1 - cfg.rho) * torch.square(tmp))
            p.sub_(tmp)
        elif t == "kAdam":
            b1, b2 = cfg.beta1, cfg.beta2
            h.mul_(b1).add_((1 - b1) * g)                 # first moment
            u.mul_(b2).add_((1 - b2) * torch.square(g))   # second moment
            tstep = _F(step) + _F(1)
            c1 = float(_F(1) - np.power(_F(b1), tstep))
            c2 = float(_F(1) - np.power(_F(b2), tstep))
            p.sub_(lr * (h / c1) / (torch.sqrt(u / c2) + cfg.delta))
        else:
            raise ValueError(f"unknown updater type {t!r}")


def make_updater(cfg: Optional[UpdaterConfig]) -> Updater:
    return Updater(cfg if cfg is not None else UpdaterConfig(type="kSGD"))
