"""The arithmetic every reference product runs in.

`f32` is the reference: float32 with TF32 off (`strict_f32`).  `fp8` is
the control, the nearest precision below the bfloat16 the
configurations compute in: each product's operands are rounded to
float8 (e4m3 forward, e5m2 for the gradients that flow back, each
tensor scaled by its largest magnitude, as an fp8 training recipe
scales them) and multiplied in float32.  `bf16` rounds the operands to
bfloat16, the configurations' own compute precision, for tests.
"""

from __future__ import annotations

import torch

MODES = ("f32", "fp8", "bf16")


def strict_f32() -> None:
    """Products and convolutions in true float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(t: torch.Tensor, fmt) -> torch.Tensor:
    """`t` rounded to `fmt` under a per-tensor scale, back in float32."""
    t = t.float()
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = torch.finfo(fmt).max / amax
    return (t * scale).to(fmt).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's operand in `mode`'s precision (float32 storage)."""
    if mode == "f32":
        return x
    if mode == "fp8":
        return _Fp8.apply(x)
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision mode {mode!r}; modes are {MODES}")


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.matmul(operand(a, mode), operand(b, mode))
