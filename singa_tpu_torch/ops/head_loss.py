"""Kernel K2, the fused LM-head forward, and its loss with a backward.

Port of `singa_tpu/ops/head_loss.py:35-167`.  K2 replaces the TPU kernel
`_fwd_kernel` (`:35`, launched by `_head_stats_pallas`, `:80-106`) with
the hand-written CUDA kernel in `csrc/head_fwd.cu`: one pass over vocab
tiles computes logits = h·Wᵀ with W in the tied (V, E) layout and keeps
only three per-token statistics — the online log-sum-exp, the exact
label logit, and the argmax hit (lowest index wins ties).  The logits
never reach device memory.

In bf16, the main path, the kernel runs on the tensor cores
(`mma.sync`) with V split into at most `MAX_SPLITS` ranges of whole
128-column tiles; each block writes per-row partial statistics of its
range to a workspace that `_head_stats_cuda` allocates, and a second
kernel in the same C entry merges them in V order (one counted launch).
f32 takes the kernel's scalar body.

`head_stats` launches the kernel for a CUDA tensor and runs
`head_stats_plain`, the same online pass step by step in PyTorch, for a
CPU tensor.  `head_stats_split_plain` repeats the kernel's split of V
and its merge, for the tests; nothing on the card's path calls it.  `fused_lm_xent` is a `torch.autograd.Function` whose
forward is that call and whose backward is the JAX package's chunked
`_fused_bwd` (`:136-164`) in PyTorch: the JAX backward ran in XLA
outside any Pallas kernel, so its products are `torch.matmul`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from .loss import _largest_divisor_leq

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MMA_BV = 128      # vocab columns per tile of the bf16 body (csrc MBV)
MAX_SPLITS = 8    # vocab ranges of the bf16 body, at most


def eligible(h, w_vE, bn: int = 512, bv: int = 2048) -> bool:
    """The JAX package's rule for taking the fused head
    (singa_tpu/ops/head_loss.py:109-114), unchanged."""
    n, e = h.shape
    v = w_vE.shape[0]
    return (n % bn == 0 and v % bv == 0 and e % 128 == 0
            and h.dtype == w_vE.dtype
            and h.dtype in (torch.bfloat16, torch.float32))


def _online_stats(h, w_vE, labels, v0: int, v1: int, bv: int):
    """The online pass over columns [v0, v1) in blocks of `bv`, in f32:
    per row the max logit m, the sum d of exp(logit − m), the lowest
    column holding m (a later block takes it only when strictly greater)
    and the label's logit (0 when the label lies outside)."""
    n = h.shape[0]
    dev = h.device
    hf = h.float()
    lbl = labels.long()
    m = torch.full((n,), float("-inf"), device=dev)
    d = torch.zeros((n,), device=dev)
    amax = torch.zeros((n,), dtype=torch.long, device=dev)
    ll = torch.zeros((n,), device=dev)
    for b0 in range(v0, v1, bv):
        logits = hf @ w_vE[b0:min(b0 + bv, v1)].float().T
        # argmax returns the first maximal column: lowest index wins
        bidx = torch.argmax(logits, dim=1)
        bmax = torch.gather(logits, 1, bidx[:, None])[:, 0]
        m_new = torch.maximum(m, bmax)
        d = d * torch.exp(m - m_new) + torch.sum(
            torch.exp(logits - m_new[:, None]), dim=1)
        amax = torch.where(bmax > m, bidx + b0, amax)
        m = m_new
        col = b0 + torch.arange(logits.shape[1], device=dev)
        ll = ll + torch.sum(torch.where(col[None, :] == lbl[:, None],
                                        logits, torch.zeros((), device=dev)),
                            dim=1)
    return m, d, amax, ll


def head_stats_plain(h, w_vE, labels, bv: int = 2048
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's plain PyTorch version: the kernel's online pass over vocab
    blocks of `bv` columns, in f32.  Returns (lse, label logit, hit)."""
    m, d, amax, ll = _online_stats(h, w_vE, labels, 0, w_vE.shape[0], bv)
    return m + torch.log(d), ll, (amax == labels.long()).float()


def v_splits(v: int) -> Tuple[int, int]:
    """(ranges, tiles per range) of the bf16 kernel's split of V: at most
    `MAX_SPLITS` ranges of whole `MMA_BV`-column tiles, none empty."""
    tiles = -(-v // MMA_BV)
    per = -(-tiles // min(MAX_SPLITS, tiles))
    return -(-tiles // per), per


def head_stats_split_plain(h, w_vE, labels
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The bf16 kernel's split and merge in PyTorch, for the tests: the
    online pass over each range of `v_splits`, tile by tile of
    `MMA_BV` columns, then the ranges' partials
    merged in V order, a later range taking the argmax only when
    strictly greater.  Equals `head_stats_plain` up to f32 summation
    order."""
    v = w_vE.shape[0]
    ranges, per = v_splits(v)
    cols = per * MMA_BV
    m = d = amax = ll = None
    for r in range(ranges):
        pm, pd, pa, pl = _online_stats(h, w_vE, labels, r * cols,
                                       min(v, (r + 1) * cols), MMA_BV)
        if m is None:
            m, d, amax, ll = pm, pd, pa, pl
            continue
        m_new = torch.maximum(m, pm)
        d = d * torch.exp(m - m_new) + pd * torch.exp(pm - m_new)
        amax = torch.where(pm > m, pa, amax)
        m, ll = m_new, ll + pl
    return m + torch.log(d), ll, (amax == labels.long()).float()


def _check_mma(h, w_vE) -> None:
    """K2's bf16 tensor-core body copies rows of h and W in 16-byte
    pieces: E must be a multiple of 8 and both must start on 16 bytes.
    f32 takes the scalar body, which reads element by element."""
    if h.dtype != torch.bfloat16:
        return
    if h.shape[1] % 8:
        raise ValueError(f"head_fwd in bf16 needs E a multiple of 8, not "
                         f"{h.shape[1]}")
    if h.data_ptr() % 16 or w_vE.data_ptr() % 16:
        raise ValueError("head_fwd in bf16 needs h and w that start on 16 "
                         "bytes")


def _head_stats_cuda(h, w_vE, labels):
    n, e = h.shape
    v = w_vE.shape[0]
    if w_vE.device != h.device or labels.device != h.device:
        raise ValueError("head_fwd: h, w and labels must share a device")
    if h.dtype != w_vE.dtype or h.dtype not in _DTYPE_CODE:
        raise ValueError(f"head_fwd takes h and w of one dtype, float32 "
                         f"or bfloat16; got {h.dtype} and {w_vE.dtype}")
    if not (h.is_contiguous() and w_vE.is_contiguous()):
        raise ValueError("head_fwd needs contiguous h and w")
    if labels.dtype.is_floating_point:
        raise ValueError("head_fwd needs integer labels")
    _check_mma(h, w_vE)
    lbl = labels.to(torch.int32).contiguous()
    lse, ll, hit = torch.empty((3, n), dtype=torch.float32, device=h.device)
    ws, per = None, 0
    if h.dtype == torch.bfloat16:
        # one 16-byte partial (m, d, argmax, label logit) per range and row
        ranges, per = v_splits(v)
        ws = torch.empty((ranges, n, 4), dtype=torch.float32,
                         device=h.device)
    with torch.cuda.device(h.device):
        _kernels.launch("head_fwd", h.data_ptr(), w_vE.data_ptr(),
                        lbl.data_ptr(), lse.data_ptr(), ll.data_ptr(),
                        hit.data_ptr(), None if ws is None else ws.data_ptr(),
                        n, e, v, per, _DTYPE_CODE[h.dtype])
    return lse, ll, hit


def head_stats(h, w_vE, labels
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, label logit, hit) per token for h (N, E), w_vE (V, E),
    labels (N,).  A CUDA tensor launches K2; a CPU tensor runs
    `head_stats_plain`."""
    if h.dim() != 2 or w_vE.dim() != 2 or h.shape[1] != w_vE.shape[1] \
            or labels.shape != (h.shape[0],):
        raise ValueError(f"bad head shapes h {tuple(h.shape)}, w "
                         f"{tuple(w_vE.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if h.is_cuda:
        return _head_stats_cuda(h, w_vE, labels)
    if h.device.type == "cpu":
        return head_stats_plain(h, w_vE, labels)
    raise ValueError(f"head_stats runs on cuda or cpu, not {h.device}")


def logits_f32(h, w_vE) -> torch.Tensor:
    """h·Wᵀ with an f32 result, as the JAX product's
    `preferred_element_type=f32`.  bf16 operands on CUDA go through
    cuBLAS's bf16 product with an f32 output (f32 accumulation, tensor
    cores); on the CPU, which has no such product, and for f32 operands
    the operands are taken in f32 — the same products, summed in f32."""
    if h.is_cuda and h.dtype == torch.bfloat16:
        return torch.mm(h, w_vE.T, out_dtype=torch.float32)
    return h.float() @ w_vE.float().T


def xent_backward(h, w_vE, labels, lse, coef, chunk_size: int):
    """Gradients of scale·mean(lse − label logit) w.r.t. h (N, E) and the
    (V, E) weight, chunk by chunk over the tokens, from the forward's
    per-token lse (`_fused_bwd`, singa_tpu/ops/head_loss.py:136-164):
    logits = h·Wᵀ in f32, p = exp(logits − lse), dl = (p − onehot)·coef
    cast to h's dtype, dh = dl·W, dW += dlᵀ·h accumulated in f32.  `coef`
    is dloss·scale/n (a 0-d f32 tensor).  One (chunk, V) f32 block lives
    at a time."""
    n = h.shape[0]
    c = _largest_divisor_leq(n, chunk_size)
    lbl = labels.long()
    dh = torch.empty_like(h)
    dw = torch.zeros(w_vE.shape, dtype=torch.float32, device=h.device)
    for i in range(0, n, c):
        hc = h[i:i + c]
        p = torch.exp(logits_f32(hc, w_vE) - lse[i:i + c, None])
        p[torch.arange(p.shape[0], device=h.device), lbl[i:i + c]] -= 1.0
        dl = (p * coef).to(h.dtype)
        dh[i:i + c] = dl @ w_vE
        dw += (dl.T @ hc).float()
    return dh, dw.to(w_vE.dtype)


class _FusedHead(torch.autograd.Function):
    """K2 forward (saving the per-token lse), chunked PyTorch backward —
    the JAX package's `fused_lm_xent` custom_vjp (`:117-167`)."""

    @staticmethod
    def forward(ctx, h, w_vE, labels, scale, chunk_size):
        n = h.shape[0]
        lse, ll, hit = head_stats(h, w_vE, labels)
        ctx.save_for_backward(h, w_vE, labels, lse)
        ctx.args = (scale, chunk_size)
        prec = scale * torch.sum(hit) / n
        ctx.mark_non_differentiable(prec)
        return scale * torch.sum(lse - ll) / n, prec

    @staticmethod
    def backward(ctx, dloss, _dprec):      # precision is metric-only
        h, w_vE, labels, lse = ctx.saved_tensors
        scale, chunk_size = ctx.args
        coef = dloss.float() * (scale / h.shape[0])
        dh, dw = xent_backward(h, w_vE, labels, lse, coef, chunk_size)
        return dh, dw, None, None, None


def fused_lm_xent(h, w_vE, labels, scale: float = 1.0,
                  chunk_size: int = 4096
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, top-1 precision) for an LM head with (V, E) weight through
    the fused forward (K2 on the card); differentiable in h and w_vE,
    with the backward over token chunks of `chunk_size`."""
    return _FusedHead.apply(h, w_vE, labels, scale, chunk_size)
