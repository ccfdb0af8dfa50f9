"""The partitioner over the processes of the group: the port of
`singa_tpu/parallel/partition.py`, both halves.

Under XLA a batch is `jax.device_put` under a `NamedSharding` that
splits dim 0 over the mesh's "data" axis (and, for a sequence-parallel
net, dim 1 over "seq": `seq_batch_shardings`), a param under one that
splits its `partition_dim` over "model" (`param_shardings`), and GSPMD
inserts every collective.  Here each process keeps its rank's shard of
each, and the collectives are explicit:

- **Batches.**  Every process builds the same global batch and keeps
  its rank's rows (and with sequence parallelism its chunk of dim 1):
  `shard_batch`, `DataParallel.shard`.  A layer that draws over the
  batch draws the global batch's numbers and keeps its slice
  (`core.layers.Context.global_rows`, `global_cols`).
- **Params.**  A param's placement is a record (axis, dim), or None
  where it is replicated (`param_shardings`).  A dim the axis does not
  divide is zero-padded to a multiple of it (`pad_params`) and the
  padded array is split, so an uneven dim (a 10-wide classifier on a
  model axis of 4) still shards; the pad's gradients are exactly zero,
  so Adam and weight decay keep it zero.  `shard_params` and
  `shard_opt_state` return this rank's slice of the padded arrays;
  `gather_params` is the inverse, which gathers the shards over the
  axis and unpads, so checkpoints stay spec-shaped and mesh-portable.
  Layers that partition their compute read their shards through
  `ModelShards` (`core.layers.Context.tp`); the rest gather their
  params whole at use.
- **Gradients.**  Each rank's gradients are those of its tokens' loss;
  their mean over the data × seq ranks (`DataParallel.mean`) is the
  global batch's, so every rank applies the same update.  The model
  axis is never averaged: a sharded param's gradient is its shard's,
  and a replicated param's is the same on every model rank.  Nor is
  the expert axis: its ranks see one batch (the JAX package shards a
  batch over "data" only), each expert lives on one rank, and kMoE sums
  the ranks' partial outputs and input gradients itself (`ops/moe.py`).
- **Pipeline stages.**  Under a pipe axis each rank holds its stages'
  params only (`bind(stage_owner=)`; `shard_params` drops the others,
  `gather_params` broadcasts each from its owner), and every param that
  is whole on every pipe rank (the pre and post groups', and all of a
  heterogeneous pipeline's) has its gradient summed over the pipe axis
  before the data × seq mean (`pipe_sum`): its contributions sit on
  different ranks (the embedding's on the first stage's, a tied head's
  on the last's).

That equality needs a net whose step is a mean of per-token terms.
kMoE computes over the whole batch at once (capacity, routing and its
router's aux loss), so it gathers its routing over the ranks that split
the batch and routes the global tokens (`ops/moe.py`).  Contrastive
divergence trains on the whole batch on every rank (`batch_coupling`),
so it is refused under a data or seq axis above 1 (ROADMAP.md A9).

The collectives run over gloo (`parallel/bootstrap.py`), staged through
the host.  A step that runs one runs eagerly: a gloo collective cannot
be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from .mesh import Mesh, axis_groups

Placement = Optional[Tuple[str, int]]


def batch_coupling(model_cfg) -> List[str]:
    """What in `model_cfg` computes over the whole batch at once, so that
    a rank's slice of the batch would train another function than the
    global batch: one line per cause, empty where there is none.  kMoE
    routes the global tokens (`ops/moe.py`) and is not one."""
    out = []
    if model_cfg.alg == "kContrastiveDivergence":
        out.append("alg kContrastiveDivergence (CD-k trains on the whole "
                   "batch on every rank)")
    return out


def uses_sequence_parallel(model_cfg) -> bool:
    """Whether any attention layer of `model_cfg` asks for ring or
    Ulysses attention: then token batches shard dim 1 over "seq" too."""
    return any(l.attention_param and l.attention_param.seq_parallel != "none"
               for l in (model_cfg.neuralnet.layer
                         if model_cfg.neuralnet else []))


# -- params ------------------------------------------------------------------

def _placement(spec, shape: Dict[str, int], pad_uneven: bool) -> Placement:
    axis = spec.mesh_axis or "model"
    n = shape.get(axis, 1)
    dim = spec.partition_dim
    if n > 1 and dim >= 0 and (spec.shape[dim] % n == 0 or pad_uneven):
        return (axis, dim)
    return None


def param_shardings(mesh: Mesh, net, pad_uneven: bool = False
                    ) -> Dict[str, Placement]:
    """Each param's placement, (axis, dim) or None for replicated, from
    its partition_dim and mesh_axis (by default "model"): the JAX
    package's NamedShardings as records.  A dim the axis does not divide is replicated, or with
    `pad_uneven` (arrays padded by `pad_params`) sharded over the padded
    dim, which is how the port stores it."""
    shape = mesh.shape
    return {name: _placement(spec, shape, pad_uneven)
            for name, spec in net.param_specs.items()}


def pad_params(mesh: Mesh, net, params: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Zero-pad every uneven partition dim of a spec-shaped param up to
    the next multiple of its mesh axis (an already padded one is left
    as it is)."""
    out = dict(params)
    shape = mesh.shape
    for name, spec in net.param_specs.items():
        if name not in out:
            continue
        n = shape.get(spec.mesh_axis or "model", 1)
        dim = spec.partition_dim
        t = out[name]
        if (n > 1 and dim >= 0 and spec.shape[dim] % n
                and t.shape[dim] == spec.shape[dim]):
            pad = [0, 0] * t.dim()
            # F.pad counts dims from the last
            pad[2 * (t.dim() - 1 - dim) + 1] = -spec.shape[dim] % n
            out[name] = torch.nn.functional.pad(t, pad)
    return out


def _slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k).clone()


def shard_params(mesh: Mesh, net, params: Dict[str, torch.Tensor],
                 rank: int) -> Dict[str, torch.Tensor]:
    """`rank`'s slice of each padded param (`pad_params`) over its axis;
    a replicated param as it is."""
    placed = param_shardings(mesh, net, pad_uneven=True)
    padded = pad_params(mesh, net, params)
    coords = mesh.coords(rank)
    out = {}
    for name, t in padded.items():
        where = placed.get(name)
        if where is None:
            out[name] = t
        else:
            axis, dim = where
            out[name] = _slice(t, dim, coords[axis], mesh.shape[axis])
    return out


def shard_opt_state(mesh: Mesh, net, opt_state, rank: int):
    """The optimizer state's slots sharded as their params are (param
    history lives with its shard), padded layout included."""
    return {slot: shard_params(mesh, net, tree, rank)
            for slot, tree in opt_state.items()}


class ModelShards:
    """This rank's shards over the model axis as a layer sees them in one
    forward: the axis's group, each sharded param's dim and spec shape
    (share_param aliases under their owners'), and `full`, which gathers
    a param whole (differentiably: its gradient is this rank's slice)."""

    def __init__(self, group, dims: Dict[str, int],
                 shapes: Dict[str, Tuple[int, ...]],
                 owners: Dict[str, str]):
        self.group, self.dims, self.shapes = group, dims, shapes
        self._owners = owners
        self._cache: Dict[str, torch.Tensor] = {}

    def full(self, params: Dict[str, torch.Tensor], key: str
             ) -> torch.Tensor:
        owner = self._owners.get(key, key)
        got = self._cache.get(owner)
        if got is None:
            from .comm import all_gather
            dim, shape = self.dims[key], self.shapes[key]
            got = all_gather(params[key], dim, self.group)
            got = self._cache[owner] = got.narrow(dim, 0, shape[dim])
        return got


# -- batches -----------------------------------------------------------------

def _part(x, dim: int, index: int, n: int, what: str):
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what} dim {size} is not divisible by the "
                         f"{'data' if dim == 0 else 'seq'} axis {n}")
    k = size // n
    return x[index * k:(index + 1) * k] if dim == 0 \
        else x[:, index * k:(index + 1) * k]


def shard_batch(mesh: Mesh, batch: Any, rank: int,
                data_axis: Optional[str] = "data",
                seq_axis: Optional[str] = None) -> Any:
    """`rank`'s slice of dim 0 of every leaf of `batch` (a nested dict of
    arrays or tensors) over `data_axis`, and with `seq_axis` its chunk
    of dim 1 of every leaf of rank >= 2: the layout the JAX package's
    `batch_shardings` and `seq_batch_shardings` place."""
    coords = mesh.coords(rank)
    cuts = [(0, a, "batch") for a in (data_axis,) if a] + \
        [(1, a, "sequence") for a in (seq_axis,) if a]
    cuts = [(d, coords[a], mesh.shape[a], w) for d, a, w in cuts
            if mesh.shape[a] > 1]
    if not cuts:
        return batch

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        for dim, index, n, what in cuts:
            if dim < getattr(x, "ndim", 0):
                x = _part(x, dim, index, n, what)
        return x
    return one(batch)




class DataParallel:
    """The process mesh as seen from this process: its coordinates, the
    groups of its model axis (`model`), its seq axis (`seq_group`), its
    data × seq ranks (`grads`, which average the gradients), its data
    axis (`data_group`), its pipe axis (`pipe`) and its expert axis
    (`expert`); its shard of each batch and of each param; the sum over
    pipe and the mean over data × seq; and the gathers that take sharded
    state whole.  A pipe axis above 1 runs with the data axis alone
    (ROADMAP.md A9), and the mesh must span the process group.  Every
    rank constructs it at once: the subgroups are made collectively."""

    def __init__(self, mesh: Mesh):
        from .bootstrap import process_count, process_index
        self.mesh = mesh
        self.rank = process_index()
        self.world = process_count()
        shape = mesh.shape
        if shape["pipe"] > 1:
            others = {a: shape[a] for a in ("model", "seq", "expert")
                      if shape[a] > 1}
            if others:
                raise ValueError(
                    f"a pipe axis of {shape['pipe']} runs with a data axis "
                    f"alone in the port; the mesh also asks for {others} "
                    f"(ROADMAP.md A9)")
        if mesh.size != self.world:
            raise ValueError(f"the mesh ({mesh.size} ranks) must span the "
                             f"process group ({self.world})")
        self.coords = mesh.coords(self.rank)
        self.n = shape["data"]
        self.index = self.coords["data"]
        (self.model, self.seq_group, self.grads, self.data_group, self.pipe,
         self.expert) = axis_groups(
            mesh, self.rank, (("model",), ("seq",), ("data", "seq"),
                              ("data",), ("pipe",), ("expert",)))
        # set by `bind`: the net's placements, whether its token batches
        # shard dim 1 over the seq axis, and the pipe index that owns each
        # stage param of a uniform pipeline
        self.placements: Dict[str, Placement] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._owners: Dict[str, str] = {}
        self.stage_owner: Dict[str, int] = {}
        self.seq_sharding = False

    def bind(self, net, uses_sp: bool = False,
             stage_owner: Optional[Dict[str, int]] = None
             ) -> "DataParallel":
        """Take `net`'s param placements (and its share_param aliases),
        whether it is sequence-parallel (`uses_sequence_parallel`), and
        for a uniform pipeline the pipe index that holds each stage
        param (`stage_owner`; a param not named there is whole on every
        pipe rank)."""
        self.net = net
        self.placements = param_shardings(self.mesh, net, pad_uneven=True)
        for name, where in self.placements.items():
            if where and where[0] == "expert" and \
                    net.param_specs[name].shape[where[1]] % self.expert.n:
                raise ValueError(
                    f"{name}: {net.param_specs[name].shape[where[1]]} "
                    f"experts do not divide over an expert axis of "
                    f"{self.expert.n}")
        self._shapes = {k: s.shape for k, s in net.param_specs.items()}
        self._owners = dict(net.param_aliases)
        self.seq_sharding = uses_sp and self.seq_group.n > 1
        self.stage_owner = dict(stage_owner or {})
        return self

    @property
    def shard_spec(self):
        """(index, n) along the data axis, for `NeuralNet.apply(shard=)`."""
        return (self.index, self.n) if self.n > 1 else None

    @property
    def gathers(self) -> bool:
        """Whether taking the state whole is collective (a model, expert
        or pipe axis above 1), so every rank joins each save."""
        return max(self.model.n, self.expert.n, self.pipe.n) > 1

    def shard(self, batch: Any, rows: bool = True) -> Any:
        """This rank's slice of dim 0 of every leaf of `batch` (all rows
        with `rows` False), and of a sequence-parallel net's batch its
        chunk of dim 1."""
        return shard_batch(self.mesh, batch, self.rank,
                           "data" if rows else None,
                           "seq" if self.seq_sharding else None)

    def view(self) -> Optional[ModelShards]:
        """The bound net's shards over the model axis for one forward, or
        None without a model axis."""
        if self.model.n == 1:
            return None
        dims = {k: p[1] for k, p in self.placements.items()
                if p and p[0] == "model"}
        shapes = dict(self._shapes)
        for alias, owner in self._owners.items():
            if owner in dims:
                dims[alias], shapes[alias] = dims[owner], shapes[owner]
        return ModelShards(self.model, dims, shapes, self._owners)

    def held(self, name: str) -> bool:
        """Whether this rank holds param `name` (every rank does, but a
        stage param of a uniform pipeline only on its owner)."""
        owner = self.stage_owner.get(name)
        return owner is None or owner == self.pipe.index

    def shard_params(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """This rank's shards of whole, spec-shaped params (or optimizer
        slot) of the bound net; the stage params of other pipe ranks
        dropped."""
        out = shard_params(self.mesh, self.net, params, self.rank)
        return {k: v for k, v in out.items() if self.held(k)}

    def shard_state(self, params, opt_state):
        """(params, opt_state) whole → this rank's shards."""
        return (self.shard_params(params),
                {slot: self.shard_params(t) for slot, t in opt_state.items()})

    def _axis_group(self, axis: str):
        return self.model if axis == "model" else self.expert

    def gather_params(self, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The bound net's params (or an optimizer slot) whole and
        spec-shaped from this rank's shards: gathered over their axis and
        unpadded, and each pipe rank's stage params broadcast from it.
        Collective over the model, expert and pipe axes; not
        differentiable."""
        from .comm import gather
        out = {}
        for name, t in params.items():
            where = self.placements.get(name)
            g = self._axis_group(where[0]) if where else None
            if g is None or g.n == 1:
                out[name] = t
            else:
                dim = where[1]
                out[name] = gather(t, dim, g).narrow(
                    dim, 0, self._shapes[name][dim])
        if self.pipe.n > 1 and self.stage_owner:
            out.update(self._from_owners(params))
        return out

    def _from_owners(self, tree: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Every stage param of `tree`'s kind, broadcast over the pipe
        axis from the rank that holds it: one broadcast of bytes per
        pipe rank."""
        import torch.distributed as dist
        like = next(iter(tree.values()))
        dtype, dev = like.dtype, like.device
        esize = like.element_size()
        got = {}
        g = self.pipe
        for d in range(g.n):
            names = sorted(k for k, o in self.stage_owner.items() if o == d)
            sizes = [int(np.prod(self._shapes[k])) * esize for k in names]
            if not names:
                continue
            if d == g.index:
                buf = torch.cat([tree[k].detach().to("cpu").contiguous()
                                 .reshape(-1).view(torch.uint8)
                                 for k in names])
            else:
                buf = torch.empty(sum(sizes), dtype=torch.uint8)
            dist.broadcast(buf, src=g.ranks[d], group=g.pg)
            off = 0
            for k, nb in zip(names, sizes):
                got[k] = buf[off:off + nb].view(dtype).reshape(
                    self._shapes[k]).to(dev)
                off += nb
        return got

    def gather_state(self, params, opt_state):
        """(params, opt_state) from shards → whole, spec-shaped."""
        return (self.gather_params(params),
                {slot: self.gather_params(t)
                 for slot, t in opt_state.items()})

    def sharded(self, name: str) -> bool:
        """Whether this rank holds param `name` as a shard over the model
        axis."""
        where = self.placements.get(name)
        return self.model.n > 1 and where is not None and where[0] == "model"

    def shard_group(self, name: str):
        """The group over which this rank's copy of param `name` is one
        part of the whole (its model or expert axis, or the pipe axis for
        a stage param), or None where the rank holds it whole."""
        if name in self.stage_owner and self.pipe.n > 1:
            return self.pipe
        where = self.placements.get(name)
        if where is None:
            return None
        g = self._axis_group(where[0])
        return g if g.n > 1 else None

    def pipe_sum(self, grads: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Each gradient of a param that is whole on every pipe rank summed
        over the pipe axis (one collective); a stage param's as it is."""
        if self.pipe.n == 1:
            return grads
        names = sorted(k for k in grads if k not in self.stage_owner)
        if not names:
            return grads
        from .comm import reduce_sum
        flat = torch.cat([grads[k].detach().reshape(-1).float()
                          for k in names])
        flat = reduce_sum(flat, self.pipe)
        out, off = dict(grads), 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[off:off + n].view(grads[k].shape).to(grads[k].dtype)
            off += n
        return out

    def mean(self, tensors: List[torch.Tensor],
             group=None) -> List[torch.Tensor]:
        """The mean of each tensor over the data × seq ranks (or over
        `group`), in new tensors of the same dtype on the same device,
        the same bits on every rank of the group: one `comm.reduce_sum`
        of them all as one f32 buffer, counted in `comm.STATS` under the
        group's name."""
        group = group or self.grads
        if group.n == 1 or not tensors:
            return list(tensors)
        from .comm import reduce_sum
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        out = reduce_sum(flat, group) / group.n
        res, off = [], 0
        for t in tensors:
            k = t.numel()
            res.append(out[off:off + k].view(t.shape).to(t.dtype))
            off += k
        return res

    def agree(self, *trees: Dict[str, Any], step: int = 0,
              what: str = "") -> str:
        """The sha256 of `step` and the bytes of `trees` (nested dicts of
        tensors, keys sorted; sharded params and slots are gathered
        whole first), which every rank must hold alike: raises
        RuntimeError on every rank, naming each rank's step and digest,
        when they differ.  A check for the start and the end of a run:
        it copies the trees to the host."""
        import hashlib

        import torch.distributed as dist
        h = hashlib.sha256()

        def feed(tree):
            for k in sorted(tree):
                v = tree[k]
                if isinstance(v, dict):
                    feed(v)
                else:
                    h.update(v.detach().contiguous().cpu().view(-1)
                             .view(torch.uint8).numpy().tobytes())
        def whole(tree):
            if any(isinstance(v, dict) for v in tree.values()):
                return {k: whole(v) for k, v in tree.items()}
            return self.gather_params(tree)
        for tree in trees:
            feed(whole(tree))
        mine = torch.frombuffer(bytearray(np.int64(step).tobytes()
                                          + h.digest()), dtype=torch.uint8)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        steps = [int(np.frombuffer(bytes(p[:8].tolist()), np.int64)[0])
                 for p in parts]
        digests = [bytes(p[8:].tolist()).hex() for p in parts]
        if len(set(digests)) != 1 or len(set(steps)) != 1:
            raise RuntimeError(
                f"data-parallel ranks hold different state{what}: "
                + "; ".join(f"rank {r} step {s} sha256 {d}" for r, (s, d)
                            in enumerate(zip(steps, digests))))
        return digests[0]

    def barrier(self) -> None:
        """Wait until every rank of the group reaches this call."""
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank of the group."""
        if self.world == 1:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def mean_dict(self, *trees: Dict[str, torch.Tensor], group=None
                  ) -> List[Dict[str, torch.Tensor]]:
        """`mean` over the tensors of several flat dicts in one call."""
        keys = [sorted(t) for t in trees]
        flat = self.mean([t[k] for t, ks in zip(trees, keys) for k in ks],
                         group)
        out, off = [], 0
        for ks in keys:
            out.append(dict(zip(ks, flat[off:off + len(ks)])))
            off += len(ks)
        return out
