"""Pooling with the reference's caffe ceil-mode geometry, over NHWC.

Port of `singa_tpu/ops/pool.py:29-58` and `:130-138` (SINGA's
layer.cc:476-540): pooled = ceil((h - k)/s) + 1, the input padded at the
bottom and right only; AVE divides by k·k whatever the clipping.

The padding is explicit (−inf for MAX, 0 for AVE) and the pool runs with
no `ceil_mode`: torch's ceil mode drops a last window that starts in the
padding, which the reference's geometry keeps (for k < s).  AVE sums in
f32 and casts back, as the JAX code does, through `avg_pool2d` with
`divisor_override=1` (a window sum; torch's default would divide a
clipped window by fewer than k·k).  Pools run on the NCHW view of the
NHWC activation, which is channels_last in memory.

MAX's backward is autograd's (`F.max_pool2d`'s), the counterpart of the
JAX package's select-and-scatter: each window's gradient goes to one
position, the first maximum in the window's row-major order, on ties too
(a ReLU's zeros tie often).  `max_pool_tie_exact` is the port of the JAX
package's tie-exact `_max_pool_nhwc` (`:60-127`), mshadow's
`unpool<red::maximum>` (tensor_expr_ext.h:148-163): every tied maximum
of a window receives the window's whole gradient.  As there, it is an
oracle for tests of tie semantics, not the production path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pooled_size(size: int, kernel: int, stride: int) -> int:
    """layer.cc:497-500: ceil((size - kernel)/stride) + 1."""
    return int(math.ceil((size - kernel) / stride)) + 1


def _ceil_pad(size: int, kernel: int, stride: int) -> int:
    out = pooled_size(size, kernel, stride)
    return max(0, (out - 1) * stride + kernel - size)


def _padded_nchw(x: torch.Tensor, kernel: int, stride: int, value: float):
    """The NCHW view of NHWC `x`, padded at the bottom and right."""
    ph = _ceil_pad(x.shape[1], kernel, stride)
    pw = _ceil_pad(x.shape[2], kernel, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph or pw:
        xc = F.pad(xc, (0, pw, 0, ph), value=value)
    return xc


def max_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Ceil-mode max pool; x (N, H, W, C) → (N, H', W', C)."""
    xc = _padded_nchw(x, kernel, stride, float("-inf"))
    return F.max_pool2d(xc, kernel, stride).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Ceil-mode average pool dividing by k·k always (layer.cc:513-515)."""
    xc = _padded_nchw(x.float(), kernel, stride, 0.0)
    s = F.avg_pool2d(xc, kernel, stride, divisor_override=1)
    return (s * (1.0 / (kernel * kernel))).to(x.dtype).permute(0, 2, 3, 1)


class _TieExactMaxPool(torch.autograd.Function):
    """The equality-mask vjp of `_max_pool_nhwc`: a tap loop over the
    window, each tap adding the gradient where its input equals its
    window's maximum (taps in row-major order, as the JAX loops add
    them)."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        y = max_pool2d(x, kernel, stride)
        ctx.save_for_backward(x, y)
        ctx.geometry = (kernel, stride)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        kernel, stride = ctx.geometry
        h, w = x.shape[1], x.shape[2]
        oh_full, ow_full = y.shape[1], y.shape[2]
        yx = y.to(x.dtype)
        dx = torch.zeros_like(x, dtype=g.dtype)
        for ki in range(kernel):
            # windows whose tap ki lands inside the unpadded input
            oh = min(oh_full, (h - 1 - ki) // stride + 1)
            hi = ki + (oh - 1) * stride + 1
            for kj in range(kernel):
                ow = min(ow_full, (w - 1 - kj) // stride + 1)
                wj = kj + (ow - 1) * stride + 1
                xs = x[:, ki:hi:stride, kj:wj:stride, :]
                hit = xs == yx[:, :oh, :ow, :]
                dx[:, ki:hi:stride, kj:wj:stride, :] += torch.where(
                    hit, g[:, :oh, :ow, :], torch.zeros((), dtype=g.dtype,
                                                        device=g.device))
        return dx, None, None


def max_pool_tie_exact(x: torch.Tensor, kernel: int,
                       stride: int) -> torch.Tensor:
    """`max_pool2d` whose backward routes a window's gradient to EVERY
    tied maximum (the JAX `_max_pool_nhwc`); x (N, H, W, C)."""
    return _TieExactMaxPool.apply(x, kernel, stride)
