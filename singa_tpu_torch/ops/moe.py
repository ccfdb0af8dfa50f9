"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch.

Port of `singa_tpu/ops/moe.py:27-87` (`moe_ffn`), step by step: the
T·k (token, expert) assignments are sorted by expert id (stably, so
earlier tokens keep queue priority), ranked within each expert's run by
a cumsum of the one-hot, clipped at the capacity, and written into a
dense (n_exp, capacity, E) expert batch; the expert FFNs run as two
batched products with f32 results, and the results are weighted by
their gates and added back per token in f32.  The JAX package runs this
op in XLA, not Pallas, so plain torch ops are its port.

Nothing here reads a value back to the host (no `.item()`, no
`nonzero`, no boolean-mask indexing, the capacity from shapes only), so
a train step with a kMoE layer can be captured as a CUDA graph.
Dropped assignments go to a trash row past the expert batch through
`torch.where`; the trash row is sliced away and its gradient with it.

Replays equal eager steps bit for bit with k = 2: `index_add_` (and
the backward of each `index_select`, an `index_add_` too) gives each
token's row two addends onto zero, and a + b == b + a in floating
point, so CUDA's atomics give the same bits in any order; a kept
expert-batch row gets one addend, and the trash row's many writes are
never read.  With k > 2 the atomics could sum three addends in another
order from one run to the next.

The router aux loss is Switch Transformer's: n_exp · Σ (share of the
tokens whose first choice is the expert) × (its mean probability).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .topk import top_k


def capacity(t: int, k: int, n_exp: int, capacity_factor: float) -> int:
    """Slots per expert for t tokens routed k ways: the JAX package's
    `max(int(capacity_factor * (t*k) / n_exp), 1)`, in Python floats."""
    return max(int(capacity_factor * (t * k) / n_exp), 1)


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, n_exp) f32 router softmax
    gate: torch.Tensor       # (T, k) f32 gate values, best first
    expert: torch.Tensor     # (T, k) expert ids, ties lowest-id first
    order: torch.Tensor      # (T·k,) the stable sort of the flat ids
    slot: torch.Tensor       # (T·k,) expert-batch row, in sorted order;
                             # n_exp·capacity (the trash row) if dropped


def route(tokens: torch.Tensor, router: torch.Tensor, k: int,
          cap: int) -> Routing:
    """Route (T, E) tokens through the (E, n_exp) router: the product in
    f32 on f32-upcast operands, softmax, top-k, and each assignment's row
    of the (n_exp·cap + 1, E) expert batch."""
    t = tokens.shape[0]
    n_exp = router.shape[1]
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    gate, expert = top_k(probs, k)
    # row-major flattening keeps each token's rank-0 choice first
    flat_exp = expert.reshape(t * k)
    order = torch.argsort(flat_exp, stable=True)
    sorted_exp = flat_exp[order]
    # the one-hot is (n_exp, T·k), so the cumsum runs along the
    # contiguous dim: a scan over the outer dim of a (T·k, n_exp)
    # one-hot took 1.3 ms of a 5.3 ms lm.conf train step on an H100
    onehot = sorted_exp[None, :] == torch.arange(
        n_exp, device=tokens.device)[:, None]
    rank = torch.gather(torch.cumsum(onehot.long(), dim=1) - 1, 0,
                        sorted_exp[None, :])[0]
    slot = torch.where(rank < cap, sorted_exp * cap + rank,
                       torch.full_like(rank, n_exp * cap))
    return Routing(probs, gate, expert, order, slot)


def _bmm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b batched, with an f32 result: on the card cuBLAS's 16-bit
    product with f32 accumulation; on the CPU, which has no such
    product, the same exact products summed in f32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _BmmF32(torch.autograd.Function):
    """a·b (batched) with an f32 result for 16-bit operands, the JAX
    package's einsum with `preferred_element_type=f32`.  Its cotangent
    is a genuine f32 (it passes through silu or the gates in f32), and
    JAX's transposed products take it in f32 against the upcast operand,
    then round to the operand's dtype; so do these."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32_out(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a·b with an f32 result, differentiable."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], k: int = 2,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, E).  params: router (E, n_exp); w1 (n_exp, E, F), b1
    (n_exp, F); w2 (n_exp, F, E), b2 (n_exp, E), in x's dtype.

    Returns (out (B, S, E) in x's dtype, the f32 router aux loss)."""
    b, s, e = x.shape
    n_exp = params["router"].shape[1]
    t = b * s
    tokens = x.reshape(t, e)
    cap = capacity(t, k, n_exp, capacity_factor)
    r = route(tokens, params["router"], k, cap)

    flat_tok = torch.arange(t * k, device=x.device) // k
    tok_idx = flat_tok[r.order]
    buf = x.new_zeros((n_exp * cap + 1, e)).index_put(
        (r.slot,), tokens.index_select(0, tok_idx))
    exp_in = buf[:-1].reshape(n_exp, cap, e)

    h = bmm_f32(exp_in, params["w1"]) + params["b1"][:, None, :].float()
    h = F.silu(h)
    out = bmm_f32(h.to(x.dtype), params["w2"]) \
        + params["b2"][:, None, :].float()

    out_flat = torch.cat([out.reshape(n_exp * cap, e),
                          out.new_zeros((1, e))])
    gate = r.gate.reshape(t * k)[r.order]
    out_sorted = out_flat.index_select(0, r.slot) * gate[:, None]
    y = torch.zeros((t, e), dtype=torch.float32,
                    device=x.device).index_add(0, tok_idx, out_sorted)

    # Switch aux loss over the rank-0 choices
    first = (r.expert[:, :1] == torch.arange(n_exp, device=x.device))
    frac_tokens = torch.mean(first.float(), dim=0)
    frac_probs = torch.mean(r.probs, dim=0)
    aux = n_exp * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, s, e).to(x.dtype), aux
