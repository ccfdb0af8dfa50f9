"""Attention ops of the port: the dense reference, RoPE, GQA expansion,
and the packed flash attention with its three kernels.

Port of `singa_tpu/ops/attention.py`.  Three TPU kernels become
hand-written CUDA kernels:
  K1 `_packed_fwd_kernel` (`:335`)  -> `csrc/flash_fwd.cu`, forward O, lse
  K3 `_packed_dq_kernel` (`:418`)   -> `csrc/flash_dq.cu`, dQ
  K4 `_packed_dkv_kernel` (`:479`)  -> `csrc/flash_dkv.cu`, dK and dV
Each has a plain PyTorch version here (`flash_forward_plain`,
`flash_dq_plain`, `flash_dkv_plain`) that steps over the kernel's 64-row
tiles in f32.  A CUDA tensor launches the kernel; a CPU tensor runs the
plain version; there is no other path between the two.  In bf16, K1, K3
and K4 run on the tensor cores (`mma.sync`) and round P (K1, K4) and dS
(K3, K4) to bf16 before the products that take them, as the TPU kernels
do; their plain versions round at the same places.  All three fold
scale·log2e into q in q's dtype before the score product, as the TPU
kernels do (`q_ref[...] * jnp.asarray(scale * LOG2E, q_ref.dtype)`,
`:370`, `:439`, `:503`): the constant comes from `fold_constant`, once,
on the host, and in bf16 both the constant and every q·c are rounded.
f32 takes the kernels' scalar bodies.

`_FlashPacked`, a `torch.autograd.Function`, carries K1 forward and K3
plus K4 backward, as the JAX package's `custom_vjp`s do (`:644-722`):
the backward forms delta = rowsum(dO*O) - dlse per head in f32 outside
the kernels (`:596-603`).  `flash_attention_packed_lse` (differentiable
in O and lse), `flash_attention_packed` and the strided
`flash_attention` (K1 with one head per row, `:135-160`) all go
through it.

Ring attention's helpers (`:48-73`, `:174-266`, `:725-751`), for
`parallel/sequence.py`: `chunk_attention` and `merge_attention` (partial
results with absolute-position masks, merged in log-sum-exp space),
`chunk_attention_blockwise` and `blockwise_attention` (the same in
kv sub-blocks), `flash_chunk` (K1 forward, K3 and K4 backward, with one
head per row and a differentiable lse), `flash_chunk_legal` and the
JAX package's block table (`flash_blocks`, `set_flash_blocks`), which
decides the routes, not the kernels' tiles.

The TPU block geometry (`flash_blocks`, `_fit_block`) is not carried
over: the CUDA kernels tile on their own terms and take any S and any
head_dim (in bf16 a multiple of 8, as the route rule asks).  What stays is the shape rule that decides the route in
kAttention (`flash_legal`), so one configuration takes the same path on
both.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
FLASH_BLOCK_K = 64    # keys per kv tile, as BK in csrc/flash_fwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def fold_constant(head_dim: int, dtype: torch.dtype) -> float:
    """scale·log2e with scale = 1/sqrt(head_dim), rounded to `dtype` as
    the TPU kernels' `jnp.asarray(scale * LOG2E, q_ref.dtype)` rounds it
    (from the double, once), returned as a Python float that holds that
    value exactly.  K1, K3 and K4 multiply q by it in q's dtype before
    Q·Kᵀ; their plain versions do the same."""
    c = (1.0 / math.sqrt(head_dim)) * LOG2E
    return torch.tensor(c, dtype=torch.float64).to(dtype).item()


def _fold_q(q, d: int):
    """q·c in q's dtype (rounded there, as the TPU kernels round it),
    then f32: the scores' left operand."""
    return (q * fold_constant(d, q.dtype)).float()


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
# K1, K3, K4: packed flash attention, forward and backward

FLASH_BLOCK_Q = 64    # queries per q tile, as BQ in csrc/flash_dkv.cu


def _packed_dims(q, k, num_heads: int, num_kv_heads: Optional[int]):
    """(b, sq, sk, d, hkv, g) of packed q (B, Sq, H·D), k (B, Sk, Hkv·D)."""
    b, sq, hd = q.shape
    hkv = num_kv_heads or num_heads
    return b, sq, k.shape[1], hd // num_heads, hkv, num_heads // hkv


def _row_stats(t, hkv: int, g: int):
    """(B, S, H) per-head row statistics → (B, Hkv, G, S) f32."""
    b, s, _ = t.shape
    return t.float().reshape(b, s, hkv, g).permute(0, 2, 3, 1)


def _tile_probs(s, lse2, qpos, kpos, causal: bool):
    """P = exp2(s − lse·log2e) of base-2 scores, causal-masked."""
    if causal:
        s = s.masked_fill(qpos < kpos, NEG_INF)
    return torch.exp2(s - lse2)


def flash_forward_plain(q, k, v, num_heads: int, causal: bool = True,
                        num_kv_heads: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain PyTorch version: the kernel's online softmax over kv
    tiles of `FLASH_BLOCK_K` keys, in f32, base 2 with scale·log2e
    folded into q in q's dtype (`_fold_q`).  P is rounded to v's dtype before its
    P·V product while l sums the unrounded P, as the kernel (and the TPU
    kernel's `p.astype(v_ref.dtype)`) does; in f32 that rounding is the
    identity.  Same inputs and outputs as `flash_attention_packed_lse`."""
    b, sq, sk, d, hkv, g = _packed_dims(q, k, num_heads, num_kv_heads)
    hd = q.shape[2]
    qh = _fold_q(q, d).reshape(b, sq, hkv, g, d)
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
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    lse = (m / LOG2E + torch.log(l_safe)).permute(0, 3, 1, 2)
    return (out.reshape(b, sq, hd).to(q.dtype),
            lse.reshape(b, sq, num_heads).contiguous())


def flash_dq_plain(q, k, v, dout, lse, delta, num_heads: int,
                   causal: bool = True,
                   num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """K3's plain PyTorch version: dQ = scale·Σ dS·K over kv tiles of
    `FLASH_BLOCK_K` keys in f32, with P recomputed from (q, k, lse) in
    base 2 and dS = P∘(dO·Vᵀ − delta), as the kernel does.  dS is rounded
    to q's dtype before dS·K, as the kernel (and the TPU kernel's
    `ds.astype(k_ref.dtype)`, `:453`) does; in f32 that rounding is the
    identity.  dout, lse and delta as `flash_dq` takes them; dQ in q's
    dtype."""
    b, sq, sk, d, hkv, g = _packed_dims(q, k, num_heads, num_kv_heads)
    scale = 1.0 / math.sqrt(d)
    qh = _fold_q(q, d).reshape(b, sq, hkv, g, d)
    doh = dout.float().reshape(b, sq, hkv, g, d)
    kh = k.float().reshape(b, sk, hkv, d)
    vh = v.float().reshape(b, sk, hkv, d)
    lse2 = _row_stats(lse, hkv, g)[..., None] * LOG2E
    dl = _row_stats(delta, hkv, g)[..., None]
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kv_end = min(sk, sq) if causal else sk
    for k0 in range(0, kv_end, FLASH_BLOCK_K):
        kb = kh[:, k0:k0 + FLASH_BLOCK_K]
        vb = vh[:, k0:k0 + FLASH_BLOCK_K]
        kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        p = _tile_probs(torch.einsum("bqhgd,bkhd->bhgqk", qh, kb), lse2,
                        qpos, kpos, causal)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doh, vb)
        ds = (p * (dp - dl)).to(q.dtype).float()
        acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", ds, kb)
    dq = (acc * scale).permute(0, 3, 1, 2, 4)
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, num_heads: int,
                    causal: bool = True, num_kv_heads: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain PyTorch version: dV = Σ Pᵀ·dO and dK = scale·Σ dSᵀ·Q
    over q tiles of `FLASH_BLOCK_Q` queries in f32, summed over each kv
    head's group of q heads, with P and dS recomputed as in
    `flash_dq_plain` from the folded q; dSᵀ·Q takes the raw q, as the
    TPU kernel does (`:521`).  P is rounded to dout's dtype before Pᵀ·dO and dS
    to q's before dSᵀ·Q, as the kernel (and the TPU kernel, `:512`,
    `:521`) does; in f32 both roundings are the identity.  (dK, dV) in
    k's and v's dtypes."""
    b, sq, sk, d, hkv, g = _packed_dims(q, k, num_heads, num_kv_heads)
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, g, d)
    qc = _fold_q(q, d).reshape(b, sq, hkv, g, d)
    doh = dout.float().reshape(b, sq, hkv, g, d)
    kh = k.float().reshape(b, sk, hkv, d)
    vh = v.float().reshape(b, sk, hkv, d)
    lse2 = _row_stats(lse, hkv, g)[..., None] * LOG2E
    dl = _row_stats(delta, hkv, g)[..., None]
    dk = torch.zeros((b, sk, hkv, d), device=q.device)
    dv = torch.zeros((b, sk, hkv, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    for q0 in range(0, sq, FLASH_BLOCK_Q):
        sl = slice(q0, q0 + FLASH_BLOCK_Q)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc[:, sl], kh)
        p = _tile_probs(s, lse2[..., sl, :], qpos[sl], kpos, causal)
        dv = dv + torch.einsum("bhgqk,bqhgd->bkhd",
                               p.to(dout.dtype).float(), doh[:, sl])
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doh[:, sl], vh)
        ds = p * (dp - dl[..., sl, :])
        dk = dk + torch.einsum("bhgqk,bqhgd->bkhd",
                               ds.to(q.dtype).float(), qf[:, sl])
    return ((dk * scale).reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def _check_packed(q, k, v, num_heads: int, kv_heads: int, dout=None,
                  stats=()) -> None:
    """Shapes of the packed layout: q (and dout) (B, Sq, H·D), k and v
    (B, Sk, Hkv·D), row statistics (B, Sq, H)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes packed (B, S, H·D) q, k, v")
    b, sq, hd = q.shape
    if (hd % num_heads or num_heads % kv_heads
            or k.shape != v.shape or k.shape[0] != b
            or k.shape[2] != kv_heads * (hd // num_heads)):
        raise ValueError(f"bad packed shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} for "
                         f"{num_heads} heads / {kv_heads} kv heads")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    for t in stats:
        if tuple(t.shape) != (b, sq, num_heads):
            raise ValueError(f"lse and delta must be {(b, sq, num_heads)}, "
                             f"not {tuple(t.shape)}")


def _check_cuda(name: str, q, operands, stats=()):
    """The kernels' contract: `operands` share q's device and dtype (f32
    or bf16), row statistics are f32, everything is contiguous."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, not {q.dtype}")
    for t in operands:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: an operand is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    for t in stats:
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be float32 on "
                             f"{q.device}")
    if not all(t.is_contiguous() for t in (q, *operands, *stats)):
        raise ValueError(f"{name} needs contiguous operands")


def _check_mma(name: str, d: int, tensors) -> None:
    """The bf16 tensor-core bodies of K1, K3 and K4 copy rows in 16-byte
    pieces: the head dim must be a multiple of 8 (as `flash_legal` asks)
    and every operand must start on 16 bytes.  f32 takes the scalar
    bodies, which read element by element."""
    if tensors[0].dtype != torch.bfloat16:
        return
    if d % 8:
        raise ValueError(f"{name} in bf16 needs a head dim that is a "
                         f"multiple of 8, not {d}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} in bf16 needs operands that start on "
                         f"16 bytes")


def _flash_forward_cuda(q, k, v, num_heads: int, causal: bool,
                        kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, sk, d, _, _ = _packed_dims(q, k, num_heads, kv_heads)
    _check_cuda("flash_fwd", q, (k, v))
    _check_mma("flash_fwd", d, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, num_heads), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch("flash_fwd", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        b, sq, sk, num_heads, kv_heads, d, int(causal),
                        fold_constant(d, q.dtype), _DTYPE_CODE[q.dtype])
    return out, lse


def _flash_dq_cuda(q, k, v, dout, lse, delta, num_heads: int, causal: bool,
                   kv_heads: int) -> torch.Tensor:
    b, sq, sk, d, _, _ = _packed_dims(q, k, num_heads, kv_heads)
    _check_cuda("flash_dq", q, (k, v, dout), (lse, delta))
    _check_mma("flash_dq", d, (q, k, v, dout))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.launch("flash_dq", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), b, sq, sk,
                        num_heads, kv_heads, d, int(causal),
                        fold_constant(d, q.dtype), _DTYPE_CODE[q.dtype])
    return dq


def _flash_dkv_cuda(q, k, v, dout, lse, delta, num_heads: int,
                    causal: bool, kv_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, sk, d, _, _ = _packed_dims(q, k, num_heads, kv_heads)
    _check_cuda("flash_dkv", q, (k, v, dout), (lse, delta))
    _check_mma("flash_dkv", d, (q, k, v, dout))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _kernels.launch("flash_dkv", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
                        sq, sk, num_heads, kv_heads, d, int(causal),
                        fold_constant(d, q.dtype), _DTYPE_CODE[q.dtype])
    return dk, dv


def _route(kernel, plain, q, *args):
    """A CUDA tensor launches the kernel, a CPU tensor runs the plain
    version; nothing else."""
    if q.is_cuda:
        return kernel(q, *args)
    if q.device.type == "cpu":
        return plain(q, *args)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_dq(q, k, v, dout, lse, delta, num_heads: int, causal: bool = True,
             num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """dQ of packed flash attention (K3 on the card): dout in q's dtype,
    lse and delta (B, Sq, H) f32 with delta = rowsum(dO∘O) − dlse."""
    _check_packed(q, k, v, num_heads, num_kv_heads or num_heads, dout,
                  (lse, delta))
    return _route(_flash_dq_cuda, flash_dq_plain, q, k, v, dout, lse, delta,
                  num_heads, causal, num_kv_heads or num_heads)


def flash_dkv(q, k, v, dout, lse, delta, num_heads: int, causal: bool = True,
              num_kv_heads: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of packed flash attention (K4 on the card); arguments as
    `flash_dq`."""
    _check_packed(q, k, v, num_heads, num_kv_heads or num_heads, dout,
                  (lse, delta))
    return _route(_flash_dkv_cuda, flash_dkv_plain, q, k, v, dout, lse,
                  delta, num_heads, causal, num_kv_heads or num_heads)


class _FlashPacked(torch.autograd.Function):
    """K1 forward, K3 and K4 backward (the JAX package's
    `_packed_lse_vjp_fwd` / `_packed_lse_vjp_bwd`, `:701-718`)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal, kv_heads):
        out, lse = _route(_flash_forward_cuda, flash_forward_plain, q, k, v,
                          num_heads, causal, kv_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (num_heads, causal, kv_heads)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        num_heads, causal, kv_heads = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        b, sq, hd = q.shape
        # delta[b, s, h] = rowsum(dO·O) within head h, from the saved O
        # upcast to f32; the lse cotangent joins it (:596-603)
        delta = torch.sum((dout.float() * out.float()).reshape(
            b, sq, num_heads, hd // num_heads), dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        dor = dout.to(q.dtype).contiguous()
        dq = flash_dq(q, k, v, dor, lse, delta, num_heads, causal, kv_heads)
        dk, dv = flash_dkv(q, k, v, dor, lse, delta, num_heads, causal,
                           kv_heads)
        return dq, dk, dv, None, None, None


def flash_attention_packed_lse(q, k, v, num_heads: int,
                               causal: bool = True,
                               num_kv_heads: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention on the packed projection layout: q (B, Sq, H·D),
    k/v (B, Sk, Hkv·D) → (O (B, Sq, H·D) in q's dtype, natural-log lse
    (B, Sq, H) f32).  GQA is native: q head h reads kv head h // (H/Hkv).
    Differentiable in both outputs.  On CUDA tensors K1 runs forward and
    K3 and K4 backward; on CPU tensors their plain versions."""
    kv_heads = num_kv_heads or num_heads
    _check_packed(q, k, v, num_heads, kv_heads)
    return _FlashPacked.apply(q, k, v, num_heads, causal, kv_heads)


def flash_attention_packed(q, k, v, num_heads: int, causal: bool = True,
                           num_kv_heads: Optional[int] = None):
    """`flash_attention_packed_lse` without the lse."""
    return flash_attention_packed_lse(q, k, v, num_heads, causal,
                                      num_kv_heads)[0]


def flash_attention(q, k, v, causal: bool = True):
    """Strided (B, H, S, D) flash attention: (B·H, S, D) is the packed
    layout with one head per row, so this is K1 (K3, K4 backward) with
    num_heads=1."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, _ = flash_attention_packed_lse(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), 1, causal)
    return out.reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# ring-attention helpers (`:48-73`, `:174-266`, `:725-751`): the local
# steps of `parallel/sequence.py`

# (block_q, block_k) pinned by `set_flash_blocks`, None for the table
_FLASH_BLOCK_OVERRIDE: Optional[tuple] = None


def set_flash_blocks(override: Optional[tuple]) -> None:
    """Pin what `flash_blocks` returns (None: the table).  In the port
    only the blockwise route reads it (its `block_k`, through the ring's
    caller); the CUDA kernels' tiles are fixed by their own design
    (`FLASH_BLOCK_Q`, `FLASH_BLOCK_K`) and take no block argument."""
    global _FLASH_BLOCK_OVERRIDE
    _FLASH_BLOCK_OVERRIDE = override


def flash_blocks(seq_len: int) -> tuple:
    """The JAX package's (block_q, block_k) table for a sequence length:
    (512, 1024) from 1024 on, else (512, 512), unless pinned."""
    if _FLASH_BLOCK_OVERRIDE is not None:
        return _FLASH_BLOCK_OVERRIDE
    if seq_len >= 1024:
        return (512, 1024)
    return (512, 512)


def chunk_attention(q, k, v, causal: bool, q_off: int, kv_off: int):
    """Partial attention of a q chunk (B, H, Sq, D) against a kv chunk
    (B, H, Sk, D) under an absolute-position causal mask (q_off and
    kv_off are the chunks' first positions).  Returns (normalized out
    f32, lse (B, H, Sq, 1)), the form `merge_attention` merges; a row
    that sees no key gives zeros and lse NEG_INF, and no NaN in either
    direction."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None] + q_off
        kpos = torch.arange(k.shape[2], device=q.device)[None, :] + kv_off
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp_min(m, NEG_INF / 2)    # guard fully masked rows
    p = torch.exp(s - m_safe)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp_min(l, 1e-30)
    lse = torch.where(l > 0, m_safe + torch.log(torch.clamp_min(l, 1e-30)),
                      torch.full_like(l, NEG_INF))
    return out, lse


def merge_attention(out1, lse1, out2, lse2):
    """Merge two partial (normalized out, lse) attention results."""
    lse = torch.logaddexp(torch.clamp_min(lse1, NEG_INF),
                          torch.clamp_min(lse2, NEG_INF))
    return (out1 * torch.exp(lse1 - lse) + out2 * torch.exp(lse2 - lse),
            lse)


def _blockwise_scan(q, k, v, causal: bool, q_off: int, kv_off: int,
                    block_k: int):
    """The kv chunk in `block_k` sub-blocks, merged online, each
    sub-block recomputed in the backward (`jax.checkpoint`)."""
    from torch.utils.checkpoint import checkpoint
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for i in range(k.shape[2] // block_k):
        sl = slice(i * block_k, (i + 1) * block_k)
        o_new, l_new = checkpoint(chunk_attention, q, k[:, :, sl],
                                  v[:, :, sl], causal, q_off,
                                  kv_off + i * block_k, use_reentrant=False)
        out, lse = merge_attention(out, lse, o_new, l_new)
    return out, lse


def chunk_attention_blockwise(q, k, v, causal: bool, q_off: int,
                              kv_off: int, block_k: int = 512):
    """`chunk_attention` with flash-style memory: a kv chunk longer than
    `block_k` (and a multiple of it) is taken in `block_k` sub-blocks
    merged online, so the score matrix is O(Sq·block_k).  Same contract
    as `chunk_attention`."""
    sk = k.shape[2]
    if sk <= block_k or sk % block_k:
        return chunk_attention(q, k, v, causal, q_off, kv_off)
    return _blockwise_scan(q, k, v, causal, q_off, kv_off, block_k)


def blockwise_attention(q, k, v, causal: bool = True, block_k: int = 512):
    """O(S·block_k)-memory attention of (B, H, S, D) q, k, v: kv blocks
    merged in log-sum-exp space, each recomputed in the backward; the
    dense reference when the blocks do not tile S.  Out in q's dtype."""
    sk = k.shape[2]
    bk = min(block_k, sk)
    if sk % bk:
        return attention_reference(q, k, v, causal)
    out, _ = _blockwise_scan(q, k, v, causal, 0, 0, bk)
    return out.to(q.dtype)


def flash_chunk(q, k, v, causal: bool):
    """Ring attention's local step on K1 (K3 and K4 backward): strided
    (B, H, Sq, D) × (B, H, Sk, D) → (normalized out f32, natural lse
    (B, H, Sq, 1)), `chunk_attention`'s contract, through
    `flash_attention_packed_lse` with one head per row.  Legal for the
    diagonal rotation (equal q and kv offsets) or causal=False (a fully
    visible rotation); the ring picks the case per rotation.  The lse is
    differentiable: `merge_attention` gives it a cotangent, which joins
    delta in the backward."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, lse = flash_attention_packed_lse(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), 1, causal)
    return (out.reshape(b, h, sq, d).float(), lse.reshape(b, h, sq, 1))


def flash_chunk_legal(sq: int, sk: int, d: int) -> bool:
    """The JAX package's rule for whether `flash_chunk` tiles these local
    chunk shapes (a block of at most 512 dividing each length that is a
    multiple of 8, and head_dim % 8 == 0), so both packages take the
    same route; the CUDA kernels themselves take any length."""
    def ok(n):
        c = min(512, n)
        while n % c:
            c //= 2
        return c % 8 == 0
    return sq >= 8 and sk >= 8 and d % 8 == 0 and ok(sq) and ok(sk)
