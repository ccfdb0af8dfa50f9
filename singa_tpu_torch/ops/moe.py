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

**Over several processes** (`split`, a `TokenSplit`): where a rank holds
a part of the batch (its rows under a data axis, its columns under a
seq axis), the JAX package still routes the global batch, as XLA sees
it whole: the capacity comes from the global token count, each
assignment is ranked in the global (B, S) order by the stable sort, and
the aux loss takes global shares.  So each rank routes its own tokens,
gathers the flat expert ids of every rank (T·k small integers, laid
out as (B, S, k) before the sort: another order would drop other
tokens at the capacity), ranks them as one process would, and keeps
its own assignments that the global ranking keeps; no activation
travels.  Each expert's rows are independent, so a rank runs its kept
assignments alone, in an expert batch of min(capacity, its tokens)
rows an expert.  The aux loss takes the global first-choice counts
from the gathered ids and the global probability sums; its value is
the global one on every rank, and its gradient on a rank is R times
its own tokens' part (R ranks splitting the batch), so the trainer's
mean over those ranks gives the global aux loss's gradient.

**Over an expert axis** (`experts`, an `AxisGroup`): the batch is the
same on every expert rank (the JAX package shards a batch over "data"
only), and a rank holds n_exp / ep experts of the stacked weights
(partition dim 0).  Every rank routes alike, runs its experts over
their kept assignments, and the partial outputs are summed over the
axis (`comm.all_reduce`).  The dispatched tokens and the gates enter
through `comm.copy_to`, so their gradients (partial on each rank) are
summed over the axis; the router's own path and the aux loss are
whole on every rank and are not.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .topk import top_k


def capacity(t: int, k: int, n_exp: int, capacity_factor: float) -> int:
    """Slots per expert for t tokens routed k ways: the JAX package's
    `max(int(capacity_factor * (t*k) / n_exp), 1)`, in Python floats."""
    return max(int(capacity_factor * (t * k) / n_exp), 1)


class TokenSplit(NamedTuple):
    """The ranks that split a batch's tokens, in (data, seq) order: this
    rank holds rows `group.index // cols` and columns `group.index %
    cols` of a rows × cols grid of equal blocks of the (B, S) batch."""
    group: Any
    rows: int
    cols: int


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, n_exp) f32 router softmax
    gate: torch.Tensor       # (T, k) f32 gate values, best first
    expert: torch.Tensor     # (T, k) expert ids, ties lowest-id first
    order: torch.Tensor      # (T·k,) the stable sort of the flat ids
    slot: torch.Tensor       # (T·k,) expert-batch row, in sorted order;
                             # n_local·cap (the trash row) if dropped or
                             # another rank's expert


def rank_in_experts(sorted_exp: torch.Tensor, n_exp: int,
                    mask=None) -> torch.Tensor:
    """Each sorted assignment's place in its expert's run (among those
    `mask` keeps, where given)."""
    # the one-hot is (n_exp, T·k), so the cumsum runs along the
    # contiguous dim: a scan over the outer dim of a (T·k, n_exp)
    # one-hot took 1.3 ms of a 5.3 ms lm.conf train step on an H100
    onehot = sorted_exp[None, :] == torch.arange(
        n_exp, device=sorted_exp.device)[:, None]
    if mask is not None:
        onehot = onehot & mask[None, :]
    return torch.gather(torch.cumsum(onehot.long(), dim=1) - 1, 0,
                        sorted_exp[None, :])[0]


def global_routing(expert: torch.Tensor, shape: Tuple[int, int],
                   n_exp: int, cap: int, split: TokenSplit
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, counts): which of this rank's (b·s, k) assignments the
    global ranking keeps under `cap`, and each expert's count of first
    choices over the global batch.  One gather of the flat ids over
    `split.group`."""
    from ..parallel.comm import gather
    b, s = shape
    k = expert.shape[1]
    g = split.group
    small = torch.uint8 if n_exp <= 256 else torch.int32
    ids = gather(expert.to(small).reshape(1, b, s, k), 0, g).long()
    full = ids.reshape(split.rows, split.cols, b, s, k).permute(
        0, 2, 1, 3, 4).reshape(-1)              # the (B, S, k) order
    order = torch.argsort(full, stable=True)
    rank = torch.empty_like(full)
    rank[order] = rank_in_experts(full[order], n_exp)
    d, c = divmod(g.index, split.cols)
    keep = (rank < cap).reshape(split.rows, b, split.cols, s, k)[d, :, c]
    counts = torch.bincount(full.reshape(-1, k)[:, 0], minlength=n_exp)
    return keep.reshape(b * s, k), counts


def route(tokens: torch.Tensor, router: torch.Tensor, k: int,
          cap: int) -> Routing:
    """Route (T, E) tokens through the (E, n_exp) router: the product in
    f32 on f32-upcast operands, softmax, top-k, and each assignment's row
    of the (n_exp·cap + 1, E) expert batch."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    gate, expert = top_k(probs, k)
    return _slots(probs, gate, expert, cap)


def _slots(probs, gate, expert, cap, keep=None, experts=None) -> Routing:
    """The routing of (T, k) choices under `cap`: with `keep` (T, k) the
    assignments a global ranking keeps (the rest dropped), with
    `experts` (first, count) the experts this rank runs."""
    t, k = expert.shape
    n_exp = probs.shape[1]
    # row-major flattening keeps each token's rank-0 choice first
    flat_exp = expert.reshape(t * k)
    order = torch.argsort(flat_exp, stable=True)
    sorted_exp = flat_exp[order]
    if keep is None:
        rank = rank_in_experts(sorted_exp, n_exp)
        kept = rank < cap
    else:
        kept = keep.reshape(t * k)[order]
        rank = rank_in_experts(sorted_exp, n_exp, kept)
    first, n_local = experts if experts is not None else (0, n_exp)
    mine = kept & (sorted_exp >= first) & (sorted_exp < first + n_local)
    slot = torch.where(mine, (sorted_exp - first) * cap + rank,
                       torch.full_like(rank, n_local * cap))
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
            capacity_factor: float = 1.25, split: TokenSplit = None,
            experts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, E).  params: router (E, n_exp); w1 (n_exp, E, F), b1
    (n_exp, F); w2 (n_exp, F, E), b2 (n_exp, E), in x's dtype; under
    `experts` (the expert axis's `AxisGroup`) this rank's n_exp / ep
    experts of the stacked four.  `split` (a `TokenSplit`) marks x as
    this rank's block of a global batch: the routing is the global
    batch's (see the module doc).

    Returns (out (B, S, E) in x's dtype, the f32 router aux loss)."""
    from ..parallel import comm
    b, s, e = x.shape
    n_exp = params["router"].shape[1]
    t = b * s
    tokens = x.reshape(t, e)
    ranks = split.rows * split.cols if split is not None else 1
    cap = capacity(t * ranks, k, n_exp, capacity_factor)
    probs = torch.softmax(tokens.float() @ params["router"].float(), dim=-1)
    gate, expert = top_k(probs, k)
    keep = counts = None
    if split is not None:
        keep, counts = global_routing(expert, (b, s), n_exp, cap, split)
        # a token takes an expert once, so a rank keeps at most t of it
        cap = min(cap, t)
    n_local = params["w1"].shape[0]
    ep = experts if experts is not None and experts.n > 1 else None
    where = (ep.index * n_local, n_local) if ep is not None else None
    r = _slots(probs, gate, expert, cap, keep, where)

    flat_tok = torch.arange(t * k, device=x.device) // k
    tok_idx = flat_tok[r.order]
    sent, gate = tokens, r.gate
    if ep is not None:
        sent, gate = comm.copy_to(tokens, ep), comm.copy_to(gate, ep)
    buf = x.new_zeros((n_local * cap + 1, e)).index_put(
        (r.slot,), sent.index_select(0, tok_idx))
    exp_in = buf[:-1].reshape(n_local, cap, e)

    h = bmm_f32(exp_in, params["w1"]) + params["b1"][:, None, :].float()
    h = F.silu(h)
    out = bmm_f32(h.to(x.dtype), params["w2"]) \
        + params["b2"][:, None, :].float()

    out_flat = torch.cat([out.reshape(n_local * cap, e),
                          out.new_zeros((1, e))])
    gate = gate.reshape(t * k)[r.order]
    out_sorted = out_flat.index_select(0, r.slot) * gate[:, None]
    y = torch.zeros((t, e), dtype=torch.float32,
                    device=x.device).index_add(0, tok_idx, out_sorted)
    if ep is not None:
        y = comm.all_reduce(y, ep)

    # Switch aux loss over the rank-0 choices
    if split is None:
        first = (r.expert[:, :1] == torch.arange(n_exp, device=x.device))
        frac_tokens = torch.mean(first.float(), dim=0)
        frac_probs = torch.mean(r.probs, dim=0)
        aux = n_exp * torch.sum(frac_tokens * frac_probs)
    else:
        total = t * ranks
        frac_tokens = counts.float() / total
        mine = r.probs.sum(dim=0)
        whole = comm.reduce_sum(mine.detach(), split.group)
        aux = n_exp * torch.sum(frac_tokens * whole / total)
        part = ranks * n_exp * torch.sum(frac_tokens * mine / total)
        aux = aux + (part - part.detach())
    return y.reshape(b, s, e).to(x.dtype), aux
