"""Data parallelism over the processes of the group: the data half of
`singa_tpu/parallel/partition.py`.

Under XLA a batch is `jax.device_put` under a `NamedSharding` that
splits dim 0 over the mesh's "data" axis (`batch_shardings`,
`shard_batch`), and XLA inserts the gradient psum.  Here every process
builds the same global batch and keeps its rank's slice of dim 0
(`shard_batch`, `DataParallel.shard`); the gradients, and the step's
metrics, are averaged over the data axis (`DataParallel.mean`), so every
rank applies the same update to the same params.  A batch the data axis
does not divide is an error, as it is under XLA.  A layer that draws
over the batch draws the global batch's numbers and keeps its rank's
rows (`core.layers.Context.shard`), so a step over N processes is the
single-process step on the global batch.

That equality needs a net whose step is a mean of per-sample terms.
A net that computes over the whole batch at once (`batch_coupling`: a
kMoE layer sizes its experts' capacity, routes, and takes its router's
aux loss over the tokens it is given; contrastive divergence trains on
the whole batch on every rank) would train another function on a
rank's slice, so it is refused under a data axis above 1 until that
computation spans the group (ROADMAP.md A9).

The collective runs over gloo (`parallel/bootstrap.py`): the tensors
are packed into one f32 buffer per call, copied to the host, summed over
the ranks by one all-reduce (which hands every rank the same bits) and
copied back.  Tensor parallelism (`param_shardings`, `pad_params`,
`shard_params`, `shard_opt_state`) is ROADMAP.md A9.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .mesh import Mesh


def batch_coupling(model_cfg) -> List[str]:
    """What in `model_cfg` computes over the whole batch at once, so that
    a rank's slice of the batch would train another function than the
    global batch: one line per cause, empty where there is none."""
    out = []
    if model_cfg.alg == "kContrastiveDivergence":
        out.append("alg kContrastiveDivergence (CD-k trains on the whole "
                   "batch on every rank)")
    for layer in model_cfg.neuralnet.layer if model_cfg.neuralnet else ():
        if layer.type == "kMoE":
            out.append(f"kMoE layer {layer.name!r} (expert capacity, "
                       f"routing and the router's aux loss are computed "
                       f"over a rank's own tokens)")
    return out


def _rows(x, index: int, n: int):
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch dim {b} is not divisible by the data "
                         f"axis {n}")
    k = b // n
    return x[index * k:(index + 1) * k]


def shard_batch(mesh: Mesh, batch: Any, rank: int,
                data_axis: str = "data") -> Any:
    """`rank`'s slice of dim 0 of every leaf of `batch` (a nested dict of
    arrays or tensors), over the mesh's `data_axis`."""
    n = mesh.shape[data_axis]
    index = mesh.coords(rank)[data_axis]
    if n == 1:
        return batch

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return _rows(x, index, n)
    return one(batch)


class DataParallel:
    """The data axis of `mesh` as seen from this process: its slice of
    each batch and the mean over the axis.  Every other axis of the mesh
    must be 1, and the data axis must span the whole group."""

    def __init__(self, mesh: Mesh):
        from .bootstrap import process_count, process_index
        self.mesh = mesh
        self.rank = process_index()
        self.n = mesh.shape["data"]
        self.index = mesh.coords(self.rank)["data"]
        others = {a: s for a, s in mesh.shape.items()
                  if a != "data" and s > 1}
        if others:
            raise ValueError(f"only the data axis runs in the port; the "
                             f"mesh also asks for {others} (ROADMAP.md A9)")
        if self.n != process_count():
            raise ValueError(f"the data axis ({self.n}) must span the "
                             f"process group ({process_count()})")
        # seconds spent in the collective (host staging included), and
        # calls made: what `chip_smoke.py` reports as the exchange cost
        self.seconds = 0.0
        self.calls = 0

    @property
    def shard_spec(self):
        """(index, n) along the data axis, for `NeuralNet.apply(shard=)`."""
        return (self.index, self.n) if self.n > 1 else None

    def shard(self, batch: Any) -> Any:
        """This rank's slice of dim 0 of every leaf of `batch`."""
        return shard_batch(self.mesh, batch, self.rank)

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of each tensor over the data axis, in new tensors of
        the same dtype on the same device, the same bits on every rank."""
        if self.n == 1 or not tensors:
            return list(tensors)
        import time

        import torch.distributed as dist
        t0 = time.perf_counter()
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        host = flat.cpu()
        dist.all_reduce(host)
        host /= self.n
        out = host.to(flat.device)
        res, off = [], 0
        for t in tensors:
            k = t.numel()
            res.append(out[off:off + k].view(t.shape).to(t.dtype))
            off += k
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return res

    def agree(self, *trees: Dict[str, Any], step: int = 0,
              what: str = "") -> str:
        """The sha256 of `step` and the bytes of `trees` (nested dicts of
        tensors, keys sorted), which every rank must hold alike: raises
        RuntimeError on every rank, naming each rank's step and digest,
        when they differ.  A check for the start and the end of a run:
        it copies the trees to the host."""
        import hashlib

        import numpy as np
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
        for tree in trees:
            feed(tree)
        mine = torch.frombuffer(bytearray(np.int64(step).tobytes()
                                          + h.digest()), dtype=torch.uint8)
        parts = [torch.empty_like(mine) for _ in range(self.n)]
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
        if self.n > 1:
            import torch.distributed as dist
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank of the data axis."""
        if self.n == 1:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def mean_dict(self, *trees: Dict[str, torch.Tensor]
                  ) -> List[Dict[str, torch.Tensor]]:
        """`mean` over the tensors of several flat dicts in one call."""
        keys = [sorted(t) for t in trees]
        flat = self.mean([t[k] for t, ks in zip(trees, keys) for k in ks])
        out, off = [], 0
        for ks in keys:
            out.append(dict(zip(ks, flat[off:off + len(ks)])))
            off += len(ks)
        return out
