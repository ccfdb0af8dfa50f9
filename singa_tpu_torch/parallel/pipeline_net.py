"""Config-driven pipeline parallelism: LayerProto.locationid → stages.

Port of `singa_tpu/parallel/pipeline_net.py`.  The reference moves
activations between layer `locationid`s through BridgeSrc/BridgeDst
over ZMQ (model.proto:128, src/worker/worker.cc:139-155,240-302); the
net's layers partition into pipeline stages by locationid, and
microbatched activations hop stage to stage over the pipe axis of the
process mesh (`parallel/pipeline.py`).

Stage assignment contract (validated, fail-loud), as in the JAX package:
  * locationid 0 layers topologically BEFORE the first staged layer form
    the `pre` group (data, parsers, embedding); every pipe rank runs it
    (the last one needs the labels), and only the first stage reads its
    output;
  * locationid 1..S mark the S pipeline stages.  `PipelineNet` needs
    them structurally identical (the same layer types and param shapes,
    in order: transformer blocks), each consuming the previous stage's
    last layer; `HeteroPipelineNet` takes any structure, each stage
    consuming exactly one tensor of the previous stage;
  * locationid 0 layers topologically AFTER the staged region form the
    `post` group (head and loss), which runs on the last pipe rank
    only; its loss and metrics are broadcast over the pipe axis.

Params: under `PipelineNet` each pipe rank holds only its stages' params
(`owners`, which the trainer gives `DataParallel.bind`), with the
circular schedule's stages d, d+P, … on rank d; the pre and post
groups' params are whole on every pipe rank, and so is every param of a
`HeteroPipelineNet` (the JAX package's choice, `:308-314`).  A param
whole on every pipe rank has its gradient summed over the pipe axis
(`DataParallel.pipe_sum`): the embedding's part is on the first rank, a
tied head's on the last.

Data rows: the JAX package shards each microbatch's rows over "data"
(`_data_batch_axis`); here a data rank holds a contiguous block of the
global batch (`partition.shard_batch`) and cuts its own block into
microbatches.  The microbatches differ, their union does not: for a net
whose loss is a mean over rows, as every net here, both give the same
loss and the same gradients.

Rng-bearing layers inside stages (dropout) draw per (stage,
microbatch) cell from the step's seed (`_stage_rng`), so masks differ
across microbatches as across the rows of the unpipelined batch, and
the backward's recompute redraws them.  The port does not reproduce
Threefry, so its masks are not the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.layers import Context, fold_in
from ..core.net import NeuralNet


class PipelineError(ValueError):
    pass


class NonUniformStages(PipelineError):
    """Stages exist but are not structurally identical (different
    structure or wiring): the trainer falls back to HeteroPipelineNet."""


def stage_assignment(net: NeuralNet) -> Tuple[List[str], List[List[str]],
                                              List[str]]:
    """(pre, stages, post) layer-name groups from locationid, in the
    net's topological order."""
    topo = net.topo
    loc = {name: net.layers[name].cfg.locationid for name in topo}
    staged = [n for n in topo if loc[n] > 0]
    if not staged:
        raise PipelineError("no layer has locationid > 0")
    ids = sorted({loc[n] for n in staged})
    if ids != list(range(1, len(ids) + 1)):
        raise PipelineError(f"locationids must be contiguous 1..S, got {ids}")
    first = topo.index(staged[0])
    last = max(topo.index(n) for n in staged)
    pre = [n for n in topo[:first] if loc[n] == 0]
    mid0 = [n for n in topo[first:last + 1] if loc[n] == 0]
    if mid0:
        raise PipelineError(
            f"layers {mid0} sit between pipeline stages but have "
            f"locationid 0 — assign them to a stage")
    post = [n for n in topo[last + 1:]]
    stages = [[n for n in topo if loc[n] == s] for s in ids]
    return pre, stages, post


def _stage_param_names(net: NeuralNet, stage: List[str]) -> List[str]:
    names = []
    for lname in stage:
        for spec in net.layers[lname].param_specs:
            names.append(spec.name)
    return names


def _validate_uniform(net: NeuralNet, stages: List[List[str]]) -> None:
    def shape(p):
        owner = net.param_aliases.get(p, p)
        return net.param_specs[owner].shape
    t0 = [net.layers[n].cfg.type for n in stages[0]]
    s0 = [shape(p) for p in _stage_param_names(net, stages[0])]
    for i, st in enumerate(stages[1:], 2):
        ti = [net.layers[n].cfg.type for n in st]
        si = [shape(p) for p in _stage_param_names(net, st)]
        if ti != t0 or si != s0:
            raise NonUniformStages(
                f"stage {i} is not structurally identical to stage 1: "
                f"types {ti} vs {t0}, param shapes {si} vs {s0}")


def _external_input(net: NeuralNet, stage: List[str]) -> str:
    """The single srclayer reference crossing into this stage."""
    inside = set(stage)
    ext = []
    for lname in stage:
        for src in net.layers[lname].cfg.srclayers:
            if src not in inside:
                ext.append(src)
    uniq = sorted(set(ext))
    if len(uniq) != 1:
        raise PipelineError(
            f"stage {stage} must consume exactly one external tensor, "
            f"found {uniq}")
    return uniq[0]


def _no_moe(net: NeuralNet, stages: List[List[str]]) -> None:
    """kMoE inside a stage is refused: a stage runs without the mesh (the
    JAX stage context has mesh=None, `:293-295,414-416`), and kMoE's
    router aux loss would have no way out of the schedule."""
    for st in stages:
        for name in st:
            if net.layers[name].cfg.type == "kMoE":
                raise PipelineError(
                    f"kMoE layer {name!r} sits inside a pipeline stage, "
                    f"which the port does not run yet (ROADMAP.md A9)")


# ---------------------------------------------------------------------------
# scaffolding shared by the uniform (PipelineNet) and heterogeneous
# (HeteroPipelineNet) forms — one definition of the mesh checks, the
# pre/post group application, the data-row rule and the stage-rng fold,
# so the two pipelines cannot drift apart.


def _check_mesh(pnet, par) -> int:
    """Returns the interleave factor v = n_stages / pipe size: 1 is the
    plain GPipe schedule (one stage per rank); above 1, only for the
    uniform PipelineNet, the circular schedule (rank d runs stages d,
    d+P, …)."""
    if par is None or getattr(par, "pipe", None) is None:
        raise PipelineError(f"{type(pnet).__name__}.apply needs a mesh "
                            f"with a 'pipe' axis")
    p = par.pipe.n
    if pnet.n_stages % p:
        # a non-multiple would silently drop stages
        raise PipelineError(
            f"{pnet.n_stages} locationid stages need a pipe axis that "
            f"divides them, mesh has pipe={p}")
    v = pnet.n_stages // p
    if v > 1 and not getattr(pnet, "supports_interleave", False):
        raise PipelineError(
            f"{pnet.n_stages} stages on pipe={p} needs the "
            f"interleaved schedule, which {type(pnet).__name__} does "
            f"not support — use equal stage/axis counts")
    return v


def _pre_apply(pnet, params, batch, kw, outputs, metrics):
    """Run the pre group; returns (total_loss, staged_input)."""
    total_loss, m, _ = pnet.net.apply(params, batch, layer_subset=pnet.pre,
                                      outputs=outputs, **kw)
    metrics.update(m)
    x = outputs[pnet.stage_inputs[0]]
    # a data rank holds one block of rows of the global batch
    rows = kw["par"].n if kw["shard"] is not None else 1
    b = x.shape[0] * rows
    if b % pnet.n_micro:
        raise PipelineError(f"batch {b} not divisible by "
                            f"n_micro {pnet.n_micro}")
    if rows > 1:
        _data_batch_axis(kw["par"], b // pnet.n_micro)
    return total_loss, x


def _post_apply(pnet, params, batch, kw, outputs, metrics, total_loss,
                y, par):
    """The post group on the last pipe rank, its loss and metrics
    broadcast over the pipe axis; (total_loss, metrics, outputs).  The
    other ranks' loss carries the schedule's backward (`y`, a 0-d
    zero), and the pre group's loss counts on the first rank only."""
    import torch.distributed as dist
    g = par.pipe
    last = g.index == g.n - 1
    if g.index > 0:
        total_loss = torch.zeros_like(total_loss)
    if last:
        post_loss, m, _ = pnet.net.apply(params, batch,
                                         layer_subset=pnet.post,
                                         outputs=outputs, **kw)
        total_loss = total_loss + post_loss
        box = [{k: v.detach().cpu() for k, v in m.items()}]
    else:
        total_loss = total_loss + y.to(total_loss.dtype)
        box = [None]
    if g.n > 1:
        dist.broadcast_object_list(box, src=g.ranks[-1], group=g.pg)
    dev = total_loss.device
    metrics.update({k: v.to(dev) for k, v in box[0].items()})
    return total_loss, metrics, outputs


def _data_batch_axis(par, micro_rows: int) -> Optional[str]:
    """"data" when the global microbatch's rows divide over the data axis
    (each data rank pipelines its own rows), None without a data axis;
    a microbatch that does not divide is refused (the JAX package would
    replicate it on every data rank), since a data rank's block would
    not cut into n_micro microbatches."""
    dp = par.n if par is not None else 1
    if dp == 1:
        return None
    if micro_rows % dp:
        raise PipelineError(
            f"a microbatch of {micro_rows} rows does not divide over the "
            f"data axis ({dp}); pick pipeline_microbatches so that it does")
    return "data"


def _stage_rng(rng: Optional[int], step: Optional[int], train: bool
               ) -> Optional[int]:
    """Per-(stage, microbatch) seed base for rng-bearing stage layers."""
    return (fold_in(rng, step or 0, 0x9199)
            if rng is not None and train else None)


def _carry(params, staged) -> List[torch.Tensor]:
    """The rank's params that its stages do not read, in name order."""
    return [params[k] for k in sorted(params) if k not in staged]


class _Staged:
    """What both forms share: the stage groups, each stage's param names
    (aliases resolved to their owners) and the cell body."""

    supports_interleave = False

    def __init__(self, net: NeuralNet, n_micro: int):
        self.net = net
        self.n_micro = n_micro
        self.pre, self.stages, self.post = stage_assignment(net)
        _no_moe(net, self.stages)
        self.stage_inputs = [_external_input(net, st)
                             for st in self.stages]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def _views(self, s: int) -> Dict[str, str]:
        """{name a stage-s layer reads: the param that holds it}."""
        return {n: self.net.param_aliases.get(n, n)
                for n in _stage_param_names(self.net, self.stages[s])}

    def _run_stage(self, s, prm, inp, key, kw, forwarded):
        views = self._views(s)
        full = {n: prm[o] for n, o in views.items()}
        louts = {self.stage_inputs[s]: inp}
        topo = self.net.topo
        for name in self.stages[s]:
            layer = self.net.layers[name]
            fuse_from = getattr(layer, "fuse_from", "")
            if fuse_from:
                srcs = [louts[fuse_from]]
            else:
                srcs = [self.net._src_out(louts, src, name)
                        for src in layer.cfg.srclayers]
            ctx = Context(batch=None, train=kw["train"],
                          compute_dtype=kw.get("compute_dtype"), rng=key,
                          layer_index=topo.index(name), device=inp.device,
                          shard=kw.get("shard"))
            louts[name] = layer.apply(full, srcs, ctx)
        return louts[forwarded]

    def _kw(self, train, compute_dtype, rng, step, generators, shard,
            par) -> Dict[str, Any]:
        if train is None:
            train = self.net.phase == "kTrain"
        return dict(train=train, compute_dtype=compute_dtype, rng=rng,
                    step=step, generators=generators, shard=shard, par=par)


class HeteroPipelineNet(_Staged):
    """Pipeline parallelism for NON-uniform stages — the reference's
    bridge-layer use case: a conv net whose locationid marks cut it into
    structurally DIFFERENT stages (conv stage, fc stage, ...), any legal
    wiring (neuralnet.cc:198-323 inserts bridges for arbitrary layouts).
    Rank s runs stage s; each boundary travels at its own shape and in
    the staged input's dtype (a stage that produces another is refused,
    as the JAX package refuses it); params are whole on every pipe rank.
    Each stage consumes exactly ONE tensor of the previous stage (any
    layer of it), and exactly one staged tensor crosses into the post
    group."""

    def __init__(self, net: NeuralNet, n_micro: int):
        super().__init__(net, n_micro)
        for s in range(1, len(self.stages)):
            if self.stage_inputs[s] not in self.stages[s - 1]:
                raise PipelineError(
                    f"stage {s + 1} consumes {self.stage_inputs[s]!r}, "
                    f"which is not in stage {s}")
        staged_names = {n for st in self.stages for n in st}
        finals = {src for name in self.post
                  for src in net.layers[name].cfg.srclayers
                  if src in staged_names}
        if len(finals) != 1:
            raise PipelineError(
                f"exactly one staged tensor may cross into the post "
                f"group, found {sorted(finals)}")
        self.final = next(iter(finals))
        if self.final not in self.stages[-1]:
            raise PipelineError(
                f"the post group consumes {self.final!r}, which is not "
                f"in the last stage")
        # boundary layer whose output each stage forwards
        self.forwarded = [self.stage_inputs[s + 1]
                          for s in range(len(self.stages) - 1)]
        self.forwarded.append(self.final)

    def owners(self, pipe: int) -> Dict[str, int]:
        """Every param is whole on every pipe rank."""
        return {}

    def apply(self, params, batch, train: Optional[bool] = None,
              compute_dtype=None, rng=None, step=None, generators=None,
              shard=None, par=None):
        from .pipeline import pipeline_apply_hetero
        _check_mesh(self, par)
        kw = self._kw(train, compute_dtype, rng, step, generators, shard,
                      par)
        outputs: Dict[str, Any] = {}
        metrics: Dict[str, torch.Tensor] = {}
        total_loss, x = _pre_apply(self, params, batch, kw, outputs,
                                   metrics)
        b = x.shape[0]
        mb = b // self.n_micro

        def mb_shape(name):
            return (mb,) + tuple(self.net.layers[name].out_shape[1:])
        in_shapes = [mb_shape(n) for n in self.stage_inputs]
        s = par.pipe.index
        full = self.net._resolve_params(params)
        mine = {o: full[o] for o in self._views(s).values()}
        base = _stage_rng(rng, step, kw["train"])
        y = pipeline_apply_hetero(
            par.pipe,
            lambda st, prm, inp, key: self._run_stage(
                st, prm, inp, key, kw, self.forwarded[st]),
            mine, x.reshape((self.n_micro, mb) + tuple(x.shape[1:])),
            in_shapes, mb_shape(self.final), rng=base,
            carry=_carry(params, mine))
        if y.dim():
            outputs[self.final] = y.reshape((b,) + tuple(y.shape[2:]))
        return _post_apply(self, params, batch, kw, outputs, metrics,
                           total_loss, y, par)


class PipelineNet(_Staged):
    """Pipelined evaluator over a built NeuralNet (see module doc)."""

    supports_interleave = True

    def __init__(self, net: NeuralNet, n_micro: int):
        super().__init__(net, n_micro)
        _validate_uniform(net, self.stages)
        # the schedule forwards each stage's topologically LAST layer, so
        # anything consuming another layer of the previous stage would
        # silently get wrong numerics
        for s in range(1, len(self.stages)):
            if self.stage_inputs[s] != self.stages[s - 1][-1]:
                raise NonUniformStages(
                    f"stage {s + 1} must consume stage {s}'s last layer "
                    f"{self.stages[s - 1][-1]!r}, not "
                    f"{self.stage_inputs[s]!r}")
        last = self.stages[-1][-1]
        staged_names = {n for st in self.stages for n in st}
        for name in self.post:
            for src in net.layers[name].cfg.srclayers:
                if src in staged_names and src != last:
                    raise NonUniformStages(
                        f"post layer {name!r} consumes mid-stage layer "
                        f"{src!r}; only the final stage output "
                        f"{last!r} crosses out of the pipeline")
        self.param_names = [sorted(set(self._views(s).values()))
                            for s in range(self.n_stages)]
        for s, names in enumerate(self.param_names):
            # a param read by a stage it does not live in (share_param
            # across the boundary) would get no gradient from that stage
            outside = [n for n in names
                       if n not in _stage_param_names(net, self.stages[s])]
            if outside:
                raise NonUniformStages(
                    f"stage {s + 1} reads params it does not own "
                    f"{outside} (share_param across the stage boundary)")

    def owners(self, pipe: int) -> Dict[str, int]:
        """{stage param: the pipe rank that holds it}: virtual stage σ on
        rank σ mod P (the circular schedule's round-robin)."""
        return {n: s % pipe for s, names in enumerate(self.param_names)
                for n in names}

    def apply(self, params, batch, train: Optional[bool] = None,
              compute_dtype=None, rng=None, step=None, generators=None,
              shard=None, par=None):
        """Pipelined forward (+ loss): pre group → microbatched staged
        region over the pipe axis → post group on the last pipe rank.
        The same signature as NeuralNet.apply; returns (total_loss,
        metrics, outputs).  The pre/post groups run through
        NeuralNet.apply(layer_subset=…) so their per-layer semantics
        (fuse_from, aux losses) stay the unpipelined net's."""
        from .pipeline import cell_key, run_schedule
        virtual = _check_mesh(self, par)
        kw = self._kw(train, compute_dtype, rng, step, generators, shard,
                      par)
        outputs: Dict[str, Any] = {}
        metrics: Dict[str, torch.Tensor] = {}
        total_loss, x = _pre_apply(self, params, batch, kw, outputs,
                                   metrics)
        b = x.shape[0]
        xm = x.reshape((self.n_micro, b // self.n_micro) + tuple(x.shape[1:]))
        p, d = par.pipe.n, par.pipe.index
        mine = [{n: params[n] for n in self.param_names[w * p + d]}
                for w in range(virtual)]
        base = _stage_rng(rng, step, kw["train"])
        y = run_schedule(
            par.pipe, lambda w, prm, inp, c: self._run_stage(
                c.sigma, prm, inp, cell_key(base, c), kw,
                self.stages[c.sigma][-1]), mine, xm, virtual,
            carry=_carry(params, {k: 0 for m in mine for k in m}))
        if y.dim():
            outputs[self.stages[-1][-1]] = y.reshape(
                (b,) + tuple(y.shape[2:]))
        return _post_apply(self, params, batch, kw, outputs, metrics,
                           total_loss, y, par)
