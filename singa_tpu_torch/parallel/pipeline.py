"""Pipeline parallelism with microbatches over the pipe axis of the process
mesh.

Port of `singa_tpu/parallel/pipeline.py`: `stack_stage_params` (`:43`),
`pipeline_apply` (`:50-125`, with the one-stage path `:83-97`), the
GPipe fill-drain schedule `_schedule` (`:128-170`), the circular one
`_schedule_circular` (`:173-244`) and `pipeline_apply_hetero`
(`:247-271`).  The JAX package runs every tick on every device under
`shard_map` and hops activations with `jax.lax.ppermute`; here each
pipe rank is a process that runs its own cells, and the hops are
`comm.shift` over the pipe axis's gloo group.

The schedule is one table, `cell(d, t)`: the work of pipe rank d at tick
t of `virtual * n_micro + P - 1` ticks (P ranks).  Rank d runs work item
j = t - d, valid in [0, virtual·n_micro), which is microbatch m =
round·P + m_in at virtual stage σ = w·P + d (j = round·virtual·P + w·P +
m_in), its w-th local stage.  `virtual` = 1 is GPipe (stage d on rank
d); above 1 the circular schedule, where rank d holds stages d, d+P, …
(the reorder at `:194-199`) and microbatches loop the ring `virtual`
times.  A cell's output goes to rank d+1 (cyclically) at tick t+1,
unless the cell is final (the last stage): it is sent exactly when the
consumer's cell is valid and not fresh (stage 0's, which reads the
input), so both sides know every transfer from the table and fill and
drain ticks move nothing.

Forward and backward are one `torch.autograd.Function`.  Its forward
runs the ticks under `no_grad` and keeps only each cell's input, O(n_micro
·virtual) boundary tensors: the memory `jax.checkpoint` gives the JAX
package (`pipeline_net.py:313,422`, `remat=True`).  Its backward runs the
ticks in reverse: each cell is recomputed with grad, takes its output's
cotangent (the loss's for a final cell, else the one the next stage
sent back), and sends its input's gradient to the previous stage; every
rank makes the same sends and receives in the same order as in the
forward, mirrored.  A cell that draws (dropout) draws from a generator
seeded from the step's seed, its stage and its microbatch (`key`, the
counterpart of `fold_in(fold_in(rng, stage), microbatch)`), so the
recompute redraws its mask.

The final stage's outputs live on the last pipe rank; the other ranks
get a 0-d zero that carries the schedule's backward (add it to the
loss).  The JAX package instead broadcasts them over the axis
(`psum(outputs * mask)`, `:167`) and runs the post group everywhere.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..core.layers import fold_in


def stack_stage_params(per_stage_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack a list of per-stage param dicts along a new leading stage
    dim (leaves must match shapes across stages)."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


class Cell(NamedTuple):
    w: int          # the local stage (row of this rank's stages)
    m: int          # the microbatch
    sigma: int      # the virtual stage
    fresh: bool     # stage 0: reads the input, not a hop
    final: bool     # the last stage: its output is the pipeline's


def ticks(p: int, virtual: int, n_micro: int) -> int:
    return virtual * n_micro + p - 1


def cell(d: int, t: int, p: int, virtual: int, n_micro: int
         ) -> Optional[Cell]:
    """The work of pipe rank `d` at tick `t`, or None (fill and drain)."""
    j = t - d
    if j < 0 or j >= virtual * n_micro:
        return None
    rnd, rem = divmod(j, virtual * p)
    w, m_in = divmod(rem, p)
    sigma = w * p + d
    return Cell(w, rnd * p + m_in, sigma, sigma == 0,
                sigma == virtual * p - 1)


class _Plan(NamedTuple):
    group: Any                      # the pipe axis's AxisGroup
    virtual: int
    n_micro: int
    body: Callable                  # body(w, params, inp, cell) -> out
    names: List[List[str]]          # each local stage's param names
    in_like: Callable               # sigma -> (shape, dtype, device)


def _params_of(plan: _Plan, flat, w: int) -> Dict[str, torch.Tensor]:
    off = sum(len(n) for n in plan.names[:w])
    return dict(zip(plan.names[w], flat[off:off + len(plan.names[w])]))


def _forward(plan: _Plan, xm: torch.Tensor, flat, saved=None):
    """The forward ticks: the final outputs (on the last rank), keeping
    each cell's input in `saved` where given."""
    from .comm import shift
    g = plan.group
    d, p, v, n = g.index, g.n, plan.virtual, plan.n_micro
    outs: List[Optional[torch.Tensor]] = [None] * n
    state = None
    for t in range(ticks(p, v, n)):
        c = cell(d, t, p, v, n)
        out = None
        if c is not None:
            inp = xm[c.m] if c.fresh else state
            if saved is not None:
                saved[(c.w, c.m)] = inp
            out = plan.body(c.w, _params_of(plan, flat, c.w), inp, c)
            if c.final:
                outs[c.m] = out
            elif out.dtype != xm.dtype:
                # a hop carries the staged input's dtype; a silent cast
                # would part from the unpipelined net's numerics
                raise ValueError(
                    f"pipeline stage {c.sigma} produces {out.dtype} but "
                    f"the stage transport is {xm.dtype} (the staged "
                    f"input's dtype): run with a uniform compute_dtype or "
                    f"cast in the net")
        nxt = cell(d, t + 1, p, v, n)
        state = shift(out, g, plan.in_like(nxt.sigma) if nxt else None,
                      send=c is not None and not c.final,
                      recv=nxt is not None and not nxt.fresh,
                      cyclic=v > 1)
    return outs


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, xm, *flat):
        # past the stages' params come the rank's other params (`carry`),
        # which keep this node on the backward's path to every param the
        # rank holds: a rank whose stage reads none still runs it
        ctx.carried = len(flat) - sum(len(n) for n in plan.names)
        flat = flat[:len(flat) - ctx.carried]
        saved: Dict[tuple, torch.Tensor] = {}
        outs = _forward(plan, xm, flat, saved)
        ctx.plan, ctx.saved = plan, saved
        ctx.save_for_backward(*flat)
        ctx.x_like = (xm.shape, xm.dtype, xm.device)
        if plan.group.index == plan.group.n - 1:
            return torch.stack(outs)
        return xm.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, gy):
        from .comm import shift
        plan, saved = ctx.plan, ctx.saved
        flat = ctx.saved_tensors
        g = plan.group
        d, p, v, n = g.index, g.n, plan.virtual, plan.n_micro
        want_x = ctx.needs_input_grad[1]
        gx = torch.zeros(ctx.x_like[0], dtype=ctx.x_like[1],
                         device=ctx.x_like[2]) if want_x else None
        acc: List[Optional[torch.Tensor]] = [None] * len(flat)
        cot = None
        for t in reversed(range(ticks(p, v, n))):
            c = cell(d, t, p, v, n)
            gin = None
            if c is not None:
                g_out = gy[c.m] if c.final else cot
                off = sum(len(x) for x in plan.names[:c.w])
                mine = [t_.detach().requires_grad_(True) for t_ in
                        flat[off:off + len(plan.names[c.w])]]
                inp = saved.pop((c.w, c.m)).detach()
                needs_in = not c.fresh or want_x
                if needs_in:
                    inp.requires_grad_(True)
                with torch.enable_grad():
                    out = plan.body(c.w, dict(zip(plan.names[c.w], mine)),
                                    inp, c)
                    wrt = ([inp] if needs_in else []) + mine
                    got = torch.autograd.grad(out, wrt, g_out,
                                              allow_unused=True)
                if needs_in:
                    gin, got = got[0], got[1:]
                for i, gp in enumerate(got):
                    if gp is not None:
                        acc[off + i] = gp if acc[off + i] is None \
                            else acc[off + i] + gp
                if c.fresh:
                    if gin is not None:
                        gx[c.m] = gin
                    gin = None
            # the previous cell's output is the next stage's input
            prv = cell(d, t - 1, p, v, n)
            cot = shift(gin, g, plan.in_like(prv.sigma + 1) if prv else None,
                        send=c is not None and not c.fresh,
                        recv=prv is not None and not prv.final, step=-1,
                        cyclic=v > 1)
        return (None, gx, *acc, *([None] * ctx.carried))


def _apply(plan: _Plan, xm: torch.Tensor, flat: List[torch.Tensor],
           carry: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    if torch.is_grad_enabled() and (
            xm.requires_grad or any(t.requires_grad for t in flat)
            or any(t.requires_grad for t in carry)):
        return _Schedule.apply(plan, xm, *flat, *carry)
    outs = _forward(plan, xm, flat)
    if plan.group.index == plan.group.n - 1:
        return torch.stack(outs)
    return xm.new_zeros((), dtype=torch.float32)


def cell_key(rng: Optional[int], c: Cell) -> Optional[int]:
    """The seed of cell `c`'s draws: fold_in(rng, stage, microbatch)."""
    return None if rng is None else fold_in(rng, c.sigma, c.m)


def run_schedule(group, body: Callable[..., torch.Tensor],
                 stage_params: Sequence[Dict[str, torch.Tensor]],
                 x: torch.Tensor, virtual: int = 1,
                 in_like: Optional[Callable] = None,
                 carry: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The schedule over `group` (P > 1 ranks) with `body(w, params, mb,
    cell)` running local stage w on a microbatch; `in_like(sigma)` gives
    (shape, dtype, device) of stage sigma's input microbatch (x's by
    default).  `carry`: the rank's other params, which get no gradient
    here but make every rank run the backward wherever its params need
    gradients (every rank must: its neighbours wait on its hops).
    Returns as `pipeline_apply`."""
    n_micro, p = x.shape[0], group.n
    if len(stage_params) != virtual:
        raise ValueError(f"{len(stage_params)} local stages for virtual "
                         f"{virtual}")
    if virtual > 1 and n_micro % p:
        raise ValueError(
            f"circular schedule needs n_micro ({n_micro}) % pipe axis "
            f"({p}) == 0 (microbatches travel in rounds)")
    if n_micro < p:
        raise ValueError(f"n_micro ({n_micro}) must be >= pipeline stages "
                         f"({p}) to fill the pipeline")
    if in_like is None:
        like = (tuple(x.shape[1:]), x.dtype, x.device)
        in_like = lambda sigma: like    # noqa: E731
    names = [sorted(sp) for sp in stage_params]
    plan = _Plan(group, virtual, n_micro, body, names, in_like)
    flat = [sp[k] for sp, ks in zip(stage_params, names) for k in ks]
    return _apply(plan, x, flat, carry)


def pipeline_apply(group, stage_fn: Callable[..., torch.Tensor],
                   stage_params: Sequence[Dict[str, torch.Tensor]],
                   x: torch.Tensor, rng: Optional[int] = None,
                   virtual: int = 1) -> torch.Tensor:
    """Run microbatches through the pipeline over `group` (the pipe
    axis's `AxisGroup`; every rank of it calls this).

    stage_params: this rank's stages in local order (one dict each,
    `virtual` of them): rank d holds stages d, d+P, ….  x: (n_micro,
    micro_batch, ...) on every rank (stage 0 reads it).  With `rng` (a
    seed) stage_fn is called as stage_fn(params, mb, key), key =
    fold_in(rng, stage, microbatch), so every (stage, microbatch) cell
    draws its own numbers; without it as stage_fn(params, mb).  Every
    stage maps a microbatch to one of the same shape and dtype.
    `virtual` > 1 selects the circular schedule and needs n_micro % P
    == 0.  Returns the final stage's (n_micro, micro_batch, ...) outputs
    on the last rank, and on the others a 0-d zero carrying the
    backward.  One rank alone runs every stage in turn."""
    def call(params, inp, key):
        return stage_fn(params, inp) if key is None \
            else stage_fn(params, inp, key)

    if group.n == 1:
        outs = []
        for m in range(x.shape[0]):
            h = x[m]
            for s, params in enumerate(stage_params):
                h = call(params, h, None if rng is None
                         else fold_in(rng, s, m))
            outs.append(h)
        return torch.stack(outs)
    return run_schedule(
        group, lambda w, prm, inp, c: call(prm, inp, cell_key(rng, c)),
        stage_params, x, virtual)


def pipeline_apply_hetero(group, stage_fn: Callable[..., torch.Tensor],
                          stage_params: Dict[str, torch.Tensor],
                          x: torch.Tensor, in_shapes: Sequence[tuple],
                          out_shape: tuple, rng: Optional[int] = None,
                          carry: Sequence[torch.Tensor] = ()
                          ) -> torch.Tensor:
    """The GPipe schedule for stages of different structure: rank d runs
    stage d as `stage_fn(d, params, mb, key)` over `stage_params` (the
    params its stage reads; every param is whole on every rank, as in
    the JAX package).  Each boundary travels at its own shape:
    `in_shapes[s]` is stage s's input microbatch shape, `out_shape` the
    last stage's, and every boundary has x's dtype (the JAX package's one
    transport buffer carries no other, `pipeline_net.py:298-307`, and
    neither does this).  `carry` as in `run_schedule`.  Returns as
    `pipeline_apply`."""
    shapes = list(in_shapes) + [out_shape]
    return run_schedule(
        group, lambda w, prm, inp, c: stage_fn(c.sigma, prm, inp,
                                               cell_key(rng, c)),
        [stage_params], x, 1,
        lambda sigma: (tuple(shapes[sigma]), x.dtype, x.device), carry)
