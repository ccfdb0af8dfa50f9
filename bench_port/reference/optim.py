"""Plain float32 updaters, as SINGA's updater.cc and the configuration
state them, working on dicts of tensors.

- kSGD: g' = g + wd·wd_mult·p; h = momentum·h + lr·lr_mult·g'; p -= h.
- kAdam: g' = g + wd·p; m = b1·m + (1-b1)·g'; v = b2·v + (1-b2)·g'²;
  p -= lr·(m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + delta), t = step + 1.
Learning rates: kFixed, and kStep: base·gamma^floor(step / frequency).
`history` is the state both keep after a step (h, or m), from which the
first gradient as the updater received it is read.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def learning_rate(upd: Dict, step: int) -> float:
    method = upd.get("learning_rate_change_method", "kFixed")
    base = upd["base_learning_rate"]
    if method == "kFixed":
        return base
    if method == "kStep":
        return base * upd.get("gamma", 1.0) ** math.floor(
            step / upd["learning_rate_change_frequency"])
    raise ValueError(f"learning rate change {method!r} is not written here")


class Updater:
    def __init__(self, upd: Dict,
                 multipliers: Optional[Dict[str, Tuple[float, float]]] = None):
        self.upd = upd
        self.mult = multipliers or {}
        self.history: Dict[str, torch.Tensor] = {}
        self.second: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, step: int, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        u = self.upd
        lr = learning_rate(u, step)
        wd = u.get("weight_decay", 0.0)
        for k, p in params.items():
            lr_m, wd_m = self.mult.get(k, (1.0, 1.0))
            g = grads[k] + wd * wd_m * p if wd else grads[k]
            h = self.history.setdefault(k, torch.zeros_like(p))
            if u["type"] == "kSGD":
                h.mul_(u.get("momentum", 0.0)).add_(lr * lr_m * g)
                p.sub_(h)
            elif u["type"] == "kAdam":
                b1, b2 = u.get("beta1", 0.9), u.get("beta2", 0.999)
                v = self.second.setdefault(k, torch.zeros_like(p))
                h.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                t = step + 1
                den = (v / (1 - b2 ** t)).sqrt_().add_(u.get("delta", 1e-7))
                p.sub_(lr * lr_m * (h / (1 - b1 ** t)) / den)
            else:
                raise ValueError(f"updater {u['type']!r} is not written here")
