"""Collectives over one axis of the process mesh, differentiable where a
layer's forward runs them.

Under GSPMD the JAX package never writes a collective for tensor or
sequence parallelism: XLA inserts the all-gathers, all-reduces,
collective-permutes (ring attention's `jax.lax.ppermute`) and
all-to-alls (Ulysses' `jax.lax.all_to_all`) that the shardings imply,
and differentiates them.  Here each is a `torch.autograd.Function`
over an `AxisGroup` (the ranks of one mesh axis that share every other
coordinate), with the backward that its forward implies:

  all_reduce     sum over the group        backward: identity
  copy_to        identity                  backward: sum over the group
  all_gather     concat along a dim        backward: the rank's slice
                                           (of the group's sum, with
                                           `reduce_grad`)
  ring_rotations the tensor and its n-1    backward: the reverse ring,
                 rotations around the ring accumulated
  all_to_all     re-shard split dim →      backward: the inverse
                 concat dim                all-to-all

`all_reduce` and `copy_to` are Megatron's g and f: a row-parallel
product's partial output is summed (g), and a column-parallel product's
replicated input takes the sum of the ranks' partial input gradients
(f).  `all_gather`'s slice backward holds where everything downstream
of the gather is replicated over the group (the model axis); where
the ranks go on to compute different things from the gathered tensor
(the seq axis), `reduce_grad` sums the ranks' gradients first.

Every collective runs on gloo, staged through the host (the gradient
mean, `DataParallel.mean`, is a `reduce_sum` too): NCCL refuses two
ranks on one device, and the card's machine has one card.  So a step that runs one cannot be
captured in a CUDA graph.  Each function is one node of the autograd
graph and one collective call, so every rank of a group runs its
backward collectives in the same order: a ring's rotations are one
node even where a rank leaves a rotation unused (its gradient is then
zeros).  Reductions travel in f32; other transports keep the bits
(16-bit floats travel as bytes).  `STATS` counts, for each group by
its axes' name ("model", "seq", "data×seq", "pipe", ...), the calls,
the bytes this rank sent and the seconds spent, host staging included
(the pipe's shifts apart, as "pipe:shift").

`shift` is the pipe's `jax.lax.ppermute(x, axis, [(i, i + 1)])` (with
`cyclic`, the ring `[(i, (i + 1) % n)]` of the circular schedule),
where a rank with no source gets nothing (the JAX package's zeros).  The
pipeline schedule (`parallel/pipeline.py`) calls it in the forward of
one `autograd.Function` and the reverse shift (`step=-1`) in its
backward, with each side's flags saying whether this tick's cell sends
and receives: the sender's and the receiver's flags come from one
schedule, so they always pair, and fill and drain ticks move nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# group name → calls, bytes sent by this rank, and seconds (host
# staging included)
STATS: Dict[str, Dict[str, float]] = {}


def reset_stats() -> None:
    STATS.clear()


def stats(g: "AxisGroup", part: str = "") -> Dict[str, float]:
    """The calls, bytes and seconds counted for `g`'s axes since the
    last `reset_stats`; with `part` ("shift") those of that kind of call
    alone, which `STATS` keeps apart as "<axes>:<part>"."""
    key = f"{g.name}:{part}" if part else g.name
    return dict(STATS.get(key, {"calls": 0, "bytes": 0, "seconds": 0.0}))


@dataclass(frozen=True)
class AxisGroup:
    """The ranks of one mesh axis through this rank (in axis order),
    this rank's index among them, their gloo process group (None for a
    group of one), and the axes' name that `STATS` counts under."""
    ranks: Tuple[int, ...]
    index: int
    pg: Any = None
    name: str = ""

    @property
    def n(self) -> int:
        return len(self.ranks)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A host copy of `x` that gloo can carry bit for bit."""
    h = x.detach().to("cpu", copy=True).contiguous()
    if h.dtype in (torch.bfloat16, torch.float16):
        h = h.view(torch.uint8)     # byte pairs along the last dim
    return h


def _unwire(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in (torch.bfloat16, torch.float16):
        h = h.view(like.dtype)
    return h.to(like.device)


def _count(g: AxisGroup, t0: float, nbytes: int, part: str = "") -> None:
    key = f"{g.name}:{part}" if part else g.name
    s = STATS.setdefault(key, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += time.perf_counter() - t0


def reduce_sum(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The sum of `x` over the group, in x's dtype (summed in f32), the
    same bits on every rank; not differentiable."""
    if g.n == 1:
        return x
    import torch.distributed as dist
    t0 = time.perf_counter()
    h = x.detach().to("cpu", dtype=torch.float32, copy=True).contiguous()
    dist.all_reduce(h, group=g.pg)
    _count(g, t0, h.numel() * 4)
    return h.to(device=x.device, dtype=x.dtype)


def gather(x: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """The ranks' `x` joined along `dim` in rank order, the same bits
    on every rank; not differentiable."""
    if g.n == 1:
        return x
    import torch.distributed as dist
    t0 = time.perf_counter()
    h = _wire(x)
    parts = [torch.empty_like(h) for _ in range(g.n)]
    dist.all_gather(parts, h, group=g.pg)
    _count(g, t0, h.numel() * h.element_size())
    return _unwire(torch.cat(parts, dim=dim), x)


def _permute(x: torch.Tensor, g: AxisGroup, shift: int) -> torch.Tensor:
    """Send `x` to the rank `shift` places on and receive from the rank
    `shift` places back."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    h = _wire(x)
    buf = torch.empty_like(h)
    to = g.ranks[(g.index + shift) % g.n]
    frm = g.ranks[(g.index - shift) % g.n]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, h, to, g.pg),
                                   dist.P2POp(dist.irecv, buf, frm, g.pg)])
    for r in reqs:
        r.wait()
    _count(g, t0, h.numel() * h.element_size())
    return _unwire(buf, x)


def _wire_empty(shape, dtype) -> torch.Tensor:
    """A host buffer that receives what `_wire` sends of a tensor of
    `shape` and `dtype`."""
    if dtype in (torch.bfloat16, torch.float16):
        shape = tuple(shape[:-1]) + (2 * shape[-1],)
        dtype = torch.uint8
    return torch.empty(tuple(shape), dtype=dtype)


def shift(x: Optional[torch.Tensor], g: AxisGroup, like, *,
          send: bool = True, recv: bool = True, step: int = 1,
          cyclic: bool = False) -> Optional[torch.Tensor]:
    """Send `x` to the rank `step` places on and receive from the rank
    `step` places back, in one `batch_isend_irecv`: a send only where
    `send` and such a rank exists (or `cyclic`), a receive only where
    `recv` and such a rank exists.  `like` is (shape, dtype, device) of
    what arrives; returns it, or None where nothing arrives.  Not
    differentiable."""
    n = g.n
    if n == 1:      # a ring of one: the rank sends to itself
        return x if cyclic and send and recv else None
    import torch.distributed as dist
    to, frm = g.index + step, g.index - step
    if cyclic:
        to, frm = to % n, frm % n
    ops, nbytes, buf = [], 0, None
    t0 = time.perf_counter()
    if send and x is not None and 0 <= to < n and to != g.index:
        h = _wire(x)
        nbytes = h.numel() * h.element_size()
        ops.append(dist.P2POp(dist.isend, h, g.ranks[to], g.pg))
    if recv and 0 <= frm < n and frm != g.index:
        shape, dtype, _ = like
        buf = _wire_empty(shape, dtype)
        ops.append(dist.P2POp(dist.irecv, buf, g.ranks[frm], g.pg))
    if not ops:
        return None
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    _count(g, t0, nbytes, "shift")
    if buf is None:
        return None
    shape, dtype, device = like
    if dtype in (torch.bfloat16, torch.float16):
        buf = buf.view(dtype)
    return buf.view(tuple(shape)).to(device)


def _a2a(xs: Sequence[torch.Tensor], split: int, concat: int,
         g: AxisGroup) -> List[torch.Tensor]:
    """Each x cut into n pieces along `split`; piece j goes to rank j,
    and the pieces received are joined along `concat` in rank order.
    All xs travel in one call."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    n = g.n
    pieces = [[_wire(c) for c in x.chunk(n, dim=split)] for x in xs]
    shapes = [p[0].shape for p in pieces]
    send = torch.stack([torch.cat([p[j].reshape(-1) for p in pieces])
                        for j in range(n)])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g.pg)
    _count(g, t0, send.numel() * send.element_size())
    out, off = [], 0
    for x, shape in zip(xs, shapes):
        k = int(torch.Size(shape).numel())
        got = [recv[j, off:off + k].view(shape) for j in range(n)]
        out.append(_unwire(torch.cat(got, dim=concat), x))
        off += k
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return reduce_sum(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum(grad, ctx.g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g, reduce_grad):
        ctx.args = (dim, g, reduce_grad, x.shape[dim])
        return gather(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        dim, g, reduce_grad, k = ctx.args
        if reduce_grad:
            grad = reduce_sum(grad, g)
        return grad.narrow(dim, g.index * k, k), None, None, None


class _RingRotations(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        outs, cur = [x.view_as(x)], x
        for _ in range(g.n - 1):
            cur = _permute(cur, g, 1)
            outs.append(cur)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        # rotation s came s places back around the ring: its gradient
        # goes back s places, summed on the way with the earlier ones'
        acc = grads[-1]
        for s in range(len(grads) - 1, 0, -1):
            acc = _permute(acc, ctx.g, -1) + grads[s - 1]
        return acc, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, concat, g, *xs):
        ctx.args = (split, concat, g)
        return tuple(_a2a(xs, split, concat, g))

    @staticmethod
    def backward(ctx, *grads):
        split, concat, g = ctx.args
        return (None, None, None, *_a2a(grads, concat, split, g))


def all_reduce(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The group's sum of `x` (a row-parallel product's partials);
    the gradient passes through unchanged."""
    return x if g.n == 1 else _AllReduce.apply(x, g)


def copy_to(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """`x`, replicated over the group, entering a column-parallel
    product: its gradient is the group's sum of the ranks' gradients."""
    return x if g.n == 1 else _CopyTo.apply(x, g)


def all_gather(x: torch.Tensor, dim: int, g: AxisGroup,
               reduce_grad: bool = False) -> torch.Tensor:
    """The ranks' `x` joined along `dim` in rank order.  The gradient is
    this rank's slice of the output's gradient, or with `reduce_grad` of
    the group's sum of them."""
    if g.n == 1:
        return x
    return _AllGather.apply(x, dim % x.dim(), g, reduce_grad)


def ring_rotations(x: torch.Tensor, g: AxisGroup) -> Tuple[torch.Tensor, ...]:
    """(x, x from 1 rank back, ..., x from n-1 ranks back): the chunks
    that ring attention's rotation s holds (`jax.lax.ppermute` to rank
    i+1, s times)."""
    if g.n == 1:
        return (x,)
    return _RingRotations.apply(x, g)


def all_to_all(xs: Sequence[torch.Tensor], split: int, concat: int,
               g: AxisGroup) -> Tuple[torch.Tensor, ...]:
    """`jax.lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)` of each x, all in one call."""
    if g.n == 1:
        return tuple(xs)
    return _AllToAll.apply(split, concat, g, *xs)
