"""Attention ops of the port: the dense reference, RoPE, GQA expansion,
and kernel K1, the packed flash-attention forward.

Port of `singa_tpu/ops/attention.py`.  K1 replaces the TPU kernel
`_packed_fwd_kernel` (`:335`, launched by `_packed_forward`, `:548-584`)
with the hand-written CUDA kernel in `csrc/flash_fwd.cu`.  Its wrapper,
`flash_attention_packed_lse`, launches that kernel for a CUDA tensor and
runs `flash_forward_plain`, the same online softmax step by step in
PyTorch, for a CPU tensor; there is no other path between the two.
`flash_attention` (strided (B, H, S, D)) is the packed kernel with one
head per row, as in the JAX package (`:135-171`).

The TPU block geometry (`flash_blocks`, `_fit_block`) is not carried
over: the CUDA kernel tiles on its own terms and takes any S and any
head_dim.  What stays is the shape rule that decides the route in
kAttention (`flash_legal`), so one configuration takes the same path on
both.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
FLASH_BLOCK_K = 64    # keys per kv tile, as BK in csrc/flash_fwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_legal(seq_len: int, head_dim: int) -> bool:
    """kAttention's flash-route rule (singa_tpu/core/seq_layers.py:201-203
    and :256): seq_len % 128 == 0 and head_dim % 8 == 0."""
    return seq_len % 128 == 0 and head_dim % 8 == 0


def attention_reference(q, k, v, causal: bool = True):
    """q: (B, H, Sq, D), k/v: (B, H, Sk, D); positions count from 0."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)
        kpos = torch.arange(k.shape[2], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# RoPE + GQA helpers


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) each (S, D/2) — shared by both rope layouts."""
    # a python scalar base: no host-to-device copy (and sync) per call
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=positions.device) / (d // 2))
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate_halves(x, cos, sin):
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings. x: (B, H, S, D) with even D; positions: (S,)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rotate_halves(x, cos, sin)


def rope_packed(x: torch.Tensor, positions: torch.Tensor, num_heads: int,
                theta: float = 10000.0) -> torch.Tensor:
    """RoPE on the packed (B, S, H·D) layout: per-head rotation through a
    free trailing-dim split/merge (no transposes)."""
    b, s, hd = x.shape
    d = hd // num_heads
    cos, sin = _rope_angles(positions, d, theta)
    out = _rotate_halves(x.reshape(b, s, num_heads, d),
                         cos[None, :, None, :], sin[None, :, None, :])
    return out.reshape(b, s, hd)


def expand_kv_heads(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads. kv: (B, Hkv, S, D)."""
    hkv = kv.shape[1]
    if hkv == num_heads:
        return kv
    assert num_heads % hkv == 0
    return torch.repeat_interleave(kv, num_heads // hkv, dim=1)


# ---------------------------------------------------------------------------
# K1: packed flash-attention forward


def flash_forward_plain(q, k, v, num_heads: int, causal: bool = True,
                        num_kv_heads: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain PyTorch version: the kernel's online softmax over kv
    tiles of `FLASH_BLOCK_K` keys, in f32, base 2 with scale·log2e
    folded into q.  Same
    inputs and outputs as `flash_attention_packed_lse`."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    hkv = num_kv_heads or num_heads
    g = num_heads // hkv
    qh = q.float().reshape(b, sq, hkv, g, d) * (LOG2E / math.sqrt(d))
    kh = k.float().reshape(b, sk, hkv, d)
    vh = v.float().reshape(b, sk, hkv, d)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)
    # causal: keys at or past sq are visible to no query
    kv_end = min(sk, sq) if causal else sk
    for k0 in range(0, kv_end, FLASH_BLOCK_K):
        kb = kh[:, k0:k0 + FLASH_BLOCK_K]
        vb = vh[:, k0:k0 + FLASH_BLOCK_K]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb)
        if causal:
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s > NEG_INF / 2, torch.exp2(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    p, vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    lse = (m / LOG2E + torch.log(l_safe)).permute(0, 3, 1, 2)
    return (out.reshape(b, sq, hd).to(q.dtype),
            lse.reshape(b, sq, num_heads).contiguous())


def _flash_forward_cuda(q, k, v, num_heads: int, causal: bool,
                        kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_fwd: {name} is {t.dtype} on {t.device}"
                             f", q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, num_heads), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch("flash_fwd", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        b, sq, sk, num_heads, kv_heads, d, int(causal),
                        _DTYPE_CODE[q.dtype])
    return out, lse


def flash_attention_packed_lse(q, k, v, num_heads: int,
                               causal: bool = True,
                               num_kv_heads: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention on the packed projection layout: q (B, Sq, H·D),
    k/v (B, Sk, Hkv·D) → (O (B, Sq, H·D) in q's dtype, natural-log lse
    (B, Sq, H) f32).  GQA is native: q head h reads kv head h // (H/Hkv).
    A CUDA tensor launches K1; a CPU tensor runs `flash_forward_plain`."""
    kv_heads = num_kv_heads or num_heads
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes packed (B, S, H·D) q, k, v")
    b, sq, hd = q.shape
    if (hd % num_heads or num_heads % kv_heads
            or k.shape != v.shape or k.shape[0] != b
            or k.shape[2] != kv_heads * (hd // num_heads)):
        raise ValueError(f"bad packed shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} for "
                         f"{num_heads} heads / {kv_heads} kv heads")
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, num_heads, causal, kv_heads)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, num_heads, causal, kv_heads)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention_packed(q, k, v, num_heads: int, causal: bool = True,
                           num_kv_heads: Optional[int] = None):
    """`flash_attention_packed_lse` without the lse."""
    return flash_attention_packed_lse(q, k, v, num_heads, causal,
                                      num_kv_heads)[0]


def flash_attention(q, k, v, causal: bool = True):
    """Strided (B, H, S, D) flash attention: (B·H, S, D) is the packed
    layout with one head per row, so this is K1 with num_heads=1."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, _ = flash_attention_packed_lse(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), 1, causal)
    return out.reshape(b, h, sq, d)
