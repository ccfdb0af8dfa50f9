"""2-D convolution over NHWC activations.

Port of `singa_tpu/ops/conv.py:26-64`.  The weight keeps the reference
layout (num_filters, C·k·k); `reshape(F, C, k, k)` is OIHW in the same
element order the JAX code reshapes from (`:47`), so one weights dict
serves both packages.

Activations stay NHWC at every layer boundary, as in the JAX zoo.  The
conv itself is `F.conv2d` on the NCHW view `x.permute(0, 3, 1, 2)`: that
view is channels_last in memory, so cuDNN takes it without a copy, and
its channels_last result permuted back is a contiguous NHWC tensor.  The
JAX package computes convolution with `lax.conv_general_dilated`, not in
a Pallas kernel, so the library call is the port's counterpart.  The
bias is added after the conv in the output's dtype, as the JAX code does
(`:62-65`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv_out_size(size: int, kernel: int, stride: int, pad: int) -> int:
    """Reference formula layer.cc:37-38: (h + 2p - k)/s + 1 (floor)."""
    return (size + 2 * pad - kernel) // stride + 1


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, kernel: int,
           stride: int = 1, pad: int = 0,
           channels: Optional[int] = None) -> torch.Tensor:
    """x (N, H, W, C) → (N, H', W', F); weight (F, C·k·k)."""
    if channels is None:
        channels = x.shape[-1]
    num_filters = weight.shape[0]
    wk = weight.reshape(num_filters, channels, kernel, kernel).to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), wk, None, stride, pad)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, num_filters, 1, 1)
    return out.permute(0, 2, 3, 1)
