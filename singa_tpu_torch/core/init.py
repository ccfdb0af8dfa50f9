"""Parameter initialization on a `torch.Generator`.

Port of `singa_tpu/core/init.py` (SINGA's Param::Init, param.cc:61-99,
and the InitMethod enum, model.proto:72-93).  The distributions are the
JAX package's; the values are not, since a torch.Generator and a JAX key
draw different numbers from one seed.  Tests that need the same weights
on both sides carry them across with `singa_tpu_torch.weights`.

  kConstant            value
  kUniform             U(low, high) * value
  kUniformSqrtFanIn    U(low, high) * value / sqrt(fan_in / 3)
  kUniformSqrtFanInOut U(low, high) * value / sqrt(shape[0] + shape[1])
  kGaussain            N(mean, std) * value
  kGaussainSqrtFanIn   N(mean, std) * value / sqrt(shape[0])
  kXavier              U(-l, l), l = sqrt(6 / (shape[0] + shape[-1]))
  kMSRA                N(0, 2 / fan_in)
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..config.schema import ParamConfig


def _uniform(gen, shape, dtype, device, low, high):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return low + (high - low) * u


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def init_param(gen: torch.Generator, cfg: ParamConfig,
               shape: Sequence[int], fan_in: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Draw one param on the generator's device."""
    shape = tuple(shape)
    device = gen.device
    method = cfg.init_method
    value = cfg.value
    if method == "kConstant":
        return torch.full(shape, value, dtype=dtype, device=device)
    if method == "kUniform":
        x = _uniform(gen, shape, dtype, device, cfg.low, cfg.high)
        return x * value if value else x
    if method == "kUniformSqrtFanIn":
        x = _uniform(gen, shape, dtype, device, cfg.low, cfg.high)
        return x * (value / math.sqrt(fan_in / 3.0)) if value else x
    if method == "kUniformSqrtFanInOut":
        x = _uniform(gen, shape, dtype, device, cfg.low, cfg.high)
        return x * (value / math.sqrt(shape[0] + shape[1])) if value else x
    if method == "kGaussain":
        x = cfg.mean + cfg.std * _normal(gen, shape, dtype, device)
        return x * value if value else x
    if method == "kGaussainSqrtFanIn":
        x = cfg.mean + cfg.std * _normal(gen, shape, dtype, device)
        return x * (value / math.sqrt(shape[0])) if value else x
    if method == "kXavier":
        limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
        return _uniform(gen, shape, dtype, device, -limit, limit)
    if method == "kMSRA":
        std = math.sqrt(2.0 / max(fan_in, 1))
        return std * _normal(gen, shape, dtype, device)
    if method == "kPretrained":
        raise ValueError("kPretrained params are loaded, not initialized "
                         "(see singa_tpu_torch.weights)")
    raise ValueError(f"unknown init_method {method!r}")
