"""Inner-product (fully-connected) op.

Port of `singa_tpu/ops/linear.py:16-23` (SINGA's layer.cc:162-213):
x (B, ...) flattened to (B, vdim), weight (vdim, hdim), y = x·W + bias.
The product runs in x's dtype with an f32 result, the JAX package's
`preferred_element_type=f32`; the bias is added in f32 and the sum cast
back to x's dtype.

A bf16 product with an f32 result is `torch.mm(..., out_dtype=float32)`
on the card (cuBLAS, f32 accumulation), which autograd cannot
differentiate, so `_MatmulF32` carries it with its two products in the
backward.  On the CPU, which has no such product, the operands are taken
in f32: the same exact products, summed in f32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """a·b with an f32 result for 16-bit operands.  The cotangent arrives
    through the cast of the f32 sum back to the operands' dtype, so it
    holds values of that dtype exactly and is taken in it; each gradient
    is an f32-accumulated product rounded to its operand's dtype, as the
    JAX package's transposed products with `preferred_element_type`."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = _mm_f32(g, b.T).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = _mm_f32(a.T, g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, ...) → (B, hdim) in x's dtype."""
    x = x.reshape(x.shape[0], -1)
    w = weight.to(x.dtype)
    y = x @ w if x.dtype == torch.float32 else _MatmulF32.apply(x, w)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
