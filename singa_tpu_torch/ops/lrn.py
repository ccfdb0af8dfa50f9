"""Local response normalization (cross-channel), with kernels K5 and K6.

Port of `singa_tpu/ops/lrn.py:48-175` (SINGA's layer.cc:331-378):

    n = k + (α/L)·Σ_{|j−c| ≤ L/2} a_j²,   y = a·n^−β,   a = relu(x) if fused

and its closed-form backward (layer.cc:366-377)

    da = g·n^−β − 2β(α/L)·a·Σ_window(g·a·n^{−β−1}),  masked by x > 0 if fused.

Two TPU kernels become hand-written CUDA kernels:
  K5 `_fwd_kernel` (singa_tpu/ops/lrn_pallas.py:62)  -> csrc/lrn_fwd.cu
  K6 `_bwd_kernel` (singa_tpu/ops/lrn_pallas.py:70)  -> csrc/lrn_bwd.cu
`lrn_fwd_plain` and `lrn_bwd_plain` state their arithmetic step by step,
roundings included, as explicit window sums over shifted, zero-padded
channel slices:
  forward:  a·a in x's dtype, window sum in f32, n = s·(α/L) + k, p = n^−β
            in f32 (r·sqrt(r), r = rsqrt(n), for β = 0.75), y = f32(a)·p
            cast to x's dtype;
  backward: t = f32(g·a)·(p/n) with g·a in x's dtype, cast back to x's
            dtype before its window sum u; da = f32(g)·p − 2β(α/L)·f32(a)·u,
            zeroed where f32(x) <= 0 when fused.

The JAX package's own NHWC path (`_impl_for`, `:138-147`) computes the
window sum as a band matmul in the compute dtype and keeps the Pallas
kernels as an oracle; the port follows the kernels: `_LRN`, one
`torch.autograd.Function` saving x alone like the JAX custom_vjp, runs
`lrn_fwd` forward and `lrn_bwd` backward, which launch K5 and K6 for a
CUDA tensor and run the plain versions for a CPU tensor.  There is no
fallback between the two: a CUDA tensor whose kernel fails raises.
The kernels take any N and any C up to `MAX_CHANNELS` (the TPU kernels
need N % 128 == 0 and C % 8 == 0), any odd local_size, f32 and bf16.
Their C entries pick one of two routes by shape and alignment: the
vector route (8 channels a thread, 16-byte accesses, persistent blocks)
when C % 8 == 0 and every operand starts on 16 bytes, as AlexNet's 64
and 192 channels do; the general route otherwise (csrc/lrn_common.cuh).
"""

from __future__ import annotations

import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# one pixel's channel row must fit a block's tile (csrc/lrn_bwd.cu)
MAX_CHANNELS = 6144


def _check_local_size(local_size: int) -> None:
    if local_size < 1 or local_size % 2 != 1:
        raise ValueError(f"LRN local_size must be odd and positive, got "
                         f"{local_size}")


def _window_sum(t: torch.Tensor, local_size: int, dim: int = -1
                ) -> torch.Tensor:
    """Σ over the channel window of `t` along `dim` (zero-padded), in
    ascending channel order, in t's dtype."""
    half = local_size // 2
    dim = dim % t.dim()
    pad = [0, 0] * (t.dim() - 1 - dim) + [half, half]
    tp = torch.nn.functional.pad(t, pad)
    c = t.shape[dim]
    s = tp.narrow(dim, 0, c)
    for j in range(1, local_size):
        s = s + tp.narrow(dim, j, c)
    return s


def _p_of_n(n: torch.Tensor, beta: float) -> torch.Tensor:
    if beta == 0.75:
        r = torch.rsqrt(n)
        return r * torch.sqrt(r)
    return n ** -beta


def _relu(x: torch.Tensor, relu: bool) -> torch.Tensor:
    return torch.clamp_min(x, 0) if relu else x


def _norm_p(a: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float):
    """(n, n^−β) in f32 from a, with a·a rounded to a's dtype."""
    s = _window_sum((a * a).float(), local_size)
    n = s * (alpha / local_size) + knorm
    return n, _p_of_n(n, beta)


def lrn_fwd_plain(x: torch.Tensor, local_size: int, alpha: float,
                  beta: float, knorm: float, relu: bool) -> torch.Tensor:
    """K5's plain version on (..., C) channels-last x."""
    a = _relu(x, relu)
    _, p = _norm_p(a, local_size, alpha, beta, knorm)
    return (a.float() * p).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, local_size: int,
                  alpha: float, beta: float, knorm: float,
                  relu: bool) -> torch.Tensor:
    """K6's plain version: dx of `lrn_fwd_plain` for cotangent g."""
    a = _relu(x, relu)
    n, p = _norm_p(a, local_size, alpha, beta, knorm)
    t = ((g * a).float() * (p / n)).to(x.dtype)
    u = _window_sum(t.float(), local_size)
    da = g.float() * p - (2.0 * beta * (alpha / local_size)) * a.float() * u
    if relu:
        da = torch.where(x.float() > 0, da, torch.zeros((), device=x.device))
    return da.to(x.dtype)


def _kernel_args(x: torch.Tensor):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the LRN kernels take float32 or bfloat16, not "
                         f"{x.dtype}")
    c = x.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"the LRN kernels take at most {MAX_CHANNELS} "
                         f"channels, got {c}")
    return x.numel() // c, c


def _lrn_fwd_cuda(x, local_size, alpha, beta, knorm, relu):
    x = x.contiguous()
    npix, c = _kernel_args(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernels.launch("lrn_fwd", x.data_ptr(), y.data_ptr(), npix, c,
                        local_size, alpha, beta, knorm, int(relu),
                        _DTYPE_CODE[x.dtype])
    return y


def _lrn_bwd_cuda(x, g, local_size, alpha, beta, knorm, relu):
    x, g = x.contiguous(), g.to(x.dtype).contiguous()
    npix, c = _kernel_args(x)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernels.launch("lrn_bwd", x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                        npix, c, local_size, alpha, beta, knorm, int(relu),
                        _DTYPE_CODE[x.dtype])
    return dx


def lrn_fwd(x: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float, relu: bool) -> torch.Tensor:
    """Cross-channel LRN of channels-last x (..., C): K5 for a CUDA
    tensor, `lrn_fwd_plain` for a CPU tensor."""
    _check_local_size(local_size)
    if x.is_cuda:
        return _lrn_fwd_cuda(x, local_size, alpha, beta, knorm, relu)
    if x.device.type == "cpu":
        return lrn_fwd_plain(x, local_size, alpha, beta, knorm, relu)
    raise ValueError(f"lrn_fwd runs on cuda or cpu, not {x.device}")


def lrn_bwd(x: torch.Tensor, g: torch.Tensor, local_size: int,
            alpha: float, beta: float, knorm: float,
            relu: bool) -> torch.Tensor:
    """dx of `lrn_fwd` for cotangent g: K6 for a CUDA tensor,
    `lrn_bwd_plain` for a CPU tensor."""
    _check_local_size(local_size)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"lrn_bwd: g {tuple(g.shape)} on {g.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    if x.is_cuda:
        return _lrn_bwd_cuda(x, g, local_size, alpha, beta, knorm, relu)
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g.to(x.dtype), local_size, alpha, beta,
                             knorm, relu)
    raise ValueError(f"lrn_bwd runs on cuda or cpu, not {x.device}")


class _LRN(torch.autograd.Function):
    """K5 forward, K6 backward; the residual is x alone (the JAX
    `_lrn_nhwc` custom_vjp, `:89-135`)."""

    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, knorm, relu):
        ctx.save_for_backward(x)
        ctx.args = (local_size, alpha, beta, knorm, relu)
        return lrn_fwd(x, local_size, alpha, beta, knorm, relu)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_bwd(x, g, *ctx.args),) + (None,) * 5


def relu_lrn(x: torch.Tensor, local_size: int = 5, alpha: float = 1.0,
             beta: float = 0.75, knorm: float = 1.0,
             relu: bool = False) -> torch.Tensor:
    """(Optionally ReLU, then) cross-channel LRN of NHWC x, differentiable
    through K5 and K6 — the fused form the net selects for conv→relu→lrn
    chains (`NeuralNet._fuse_relu_lrn`)."""
    return _LRN.apply(x, local_size, alpha, beta, knorm, relu)


def lrn(x: torch.Tensor, local_size: int = 5, alpha: float = 1.0,
        beta: float = 0.75, knorm: float = 1.0) -> torch.Tensor:
    """The f32 oracle on NCHW x (N, C, H, W), the JAX package's NCHW
    branch (`:157-163`): x² in f32, window sum, y = f32(x)·n^−β."""
    _check_local_size(local_size)
    s = _window_sum(torch.square(x.float()), local_size, dim=1)
    n = s * (alpha / local_size) + knorm
    return (x.float() * _p_of_n(n, beta)).to(x.dtype)
