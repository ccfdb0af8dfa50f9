"""Elementwise activations with reference numerics.

Port of `singa_tpu/ops/activations.py` (SINGA's cxxnet_op.h:14-113).
The reference takes each gradient from the layer's output (tanh_grad(y)
= 1 - y**2, relu_grad(y) = 1[y > 0]); those are the exact derivatives of
the forwards, so autograd through these plain definitions gives the
reference backward.

ReLU: the JAX package carries a custom_vjp that takes the gradient from
the output side (`:32-55`).  `torch.relu`'s backward also reads its
result (threshold_backward on y > 0), so plain `torch.relu` has the same
gradient, 0 at x == 0 included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# scaled-tanh constants, cxxnet_op.h:77-81 (LeCun's 1.7159 * tanh(2x/3))
STANH_OUTER = 1.7159047
STANH_INNER = 0.66666667


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """cxxnet_op.h:26-30; ReLUProto.negative_slope (leaky)."""
    if negative_slope:
        return torch.where(x > 0, x, negative_slope * x)
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def stanh(x: torch.Tensor, outer_scale: float = STANH_OUTER,
          inner_scale: float = STANH_INNER) -> torch.Tensor:
    """Scaled tanh A*tanh(B*x) (cxxnet_op.h:77-81); TanhProto's
    outer/inner_scale override the defaults."""
    return outer_scale * torch.tanh(inner_scale * x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """cxxnet_op.h:48-52 log(1+exp(x)), numerically stabilized."""
    return F.softplus(x)


def bnll(x: torch.Tensor) -> torch.Tensor:
    """Binomial negative log-likelihood, cxxnet_op.h:58-62: the stable
    softplus."""
    return F.softplus(x)


def square(x: torch.Tensor) -> torch.Tensor:
    """cxxnet_op.h:71-75."""
    return x * x


def threshold(a: torch.Tensor, b) -> torch.Tensor:
    """Bernoulli mask: 1.0 where a < b else 0.0 (cxxnet_op.h:96-101)."""
    return (a < b).to(a.dtype)


def power(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise a**b (cxxnet_op.h:103-108)."""
    return torch.pow(a, b)


def sqrtop(a: torch.Tensor, b) -> torch.Tensor:
    """sqrt(a + b), the AdaDelta/RMS denominator (cxxnet_op.h:109-113)."""
    return torch.sqrt(a + b)
