"""The process mesh: the cluster config's topology over the processes of
the group.

Port of `singa_tpu/parallel/mesh.py`.  The reference's process topology
(nworkers, nservers, nprocs_per_group, nthreads_per_procs;
include/utils/cluster.h) becomes named axes, as in the JAX package:

  data    — data parallelism (worker groups and kDataPartition)
  model   — tensor parallelism (kLayerPartition)
  pipe    — pipeline stages
  seq     — sequence parallelism
  expert  — expert parallelism

Here the mesh is topology arithmetic over ranks: its "devices" are the
processes of the `torch.distributed` group, one card each (or a share
of one).  The port runs every axis (`parallel/partition.py`,
`parallel/sequence.py`, `parallel/pipeline.py`, `parallel/
pipeline_net.py`, and kMoE's experts over "expert", `ops/moe.py`), in
every combination the JAX package runs.  `axis_groups`
makes the process subgroups that the collectives of an axis run over
(`parallel/comm.py`).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config.schema import ClusterConfig
from .comm import AxisGroup

AXES = ("data", "model", "pipe", "seq", "expert")


@dataclass(frozen=True)
class Mesh:
    """Ranks laid out over `AXES` (`devices` has one dim per axis)."""
    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """`rank`'s index along each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))


def _world() -> int:
    from .bootstrap import process_count
    return process_count()


def make_mesh(devices: Optional[Sequence[int]] = None, *, data: int = 0,
              model: int = 1, pipe: int = 1, seq: int = 1,
              expert: int = 1) -> Mesh:
    """A 5-axis mesh over `devices` (the group's ranks by default).
    `data=0` means "absorb the remaining ranks"."""
    if devices is None:
        devices = list(range(_world()))
    n = len(devices)
    fixed = model * pipe * seq * expert
    if data == 0:
        if n % fixed:
            raise ValueError(
                f"{n} devices not divisible by model*pipe*seq*expert={fixed}")
        data = n // fixed
    total = data * fixed
    if total != n:
        raise ValueError(f"mesh {data}x{model}x{pipe}x{seq}x{expert}={total} "
                         f"!= {n} devices")
    return Mesh(np.asarray(devices).reshape(data, model, pipe, seq, expert))


def mesh_from_cluster(cluster: Optional[ClusterConfig],
                      net_partition_type: str = "kNone",
                      devices: Optional[Sequence[int]] = None) -> Mesh:
    """Map the ClusterProto topology onto a mesh, as the JAX package does.

    Explicit axis fields win; otherwise the legacy fields give ngroups =
    nworkers/nprocs_per_group data-parallel groups of group_size =
    nprocs_per_group*nthreads_per_procs executors each, which split the
    batch under kDataPartition/kNone (one data axis over every rank)
    and the neuron dim under kLayerPartition (data=ngroups,
    model=group_size).  A topology that cannot map exactly warns loudly
    and the axis sizes follow the rank count."""
    if devices is None:
        devices = list(range(_world()))
    n = len(devices)
    if cluster is None:
        return make_mesh(devices)
    if any((cluster.data_parallel, cluster.tensor_parallel,
            cluster.pipeline_parallel, cluster.sequence_parallel,
            cluster.expert_parallel)):
        return make_mesh(
            devices,
            data=cluster.data_parallel or 0,
            model=cluster.tensor_parallel or 1,
            pipe=cluster.pipeline_parallel or 1,
            seq=cluster.sequence_parallel or 1,
            expert=cluster.expert_parallel or 1)
    group_size = cluster.nprocs_per_group * cluster.nthreads_per_procs
    ngroups = max(cluster.nworkers // max(cluster.nprocs_per_group, 1), 1)

    def _warn(msg):
        print(f"warning: mesh_from_cluster: {msg}", file=sys.stderr)

    if ngroups * group_size != n:
        _warn(f"cluster topology ngroups={ngroups} x "
              f"group_size={group_size} != {n} devices; axis sizes "
              f"follow the device count")
    if net_partition_type == "kLayerPartition" and group_size > 1:
        tp = group_size if n % group_size == 0 \
            else math.gcd(group_size, n)
        if tp != group_size:
            _warn(f"group_size {group_size} does not divide device "
                  f"count {n}; model axis clipped to gcd {tp}")
        return make_mesh(devices, data=n // tp, model=tp)
    return make_mesh(devices)


def _group_order(mesh: Mesh, axes: Tuple[str, ...]):
    """The rank tuples of every group that varies `axes` (the other
    coordinates fixed), in one order on every rank; each tuple lists
    its ranks in the axes' order."""
    names = list(mesh.axis_names)
    moved = np.moveaxis(mesh.devices, [names.index(a) for a in axes],
                        list(range(-len(axes), 0)))
    width = int(np.prod([mesh.shape[a] for a in axes]))
    return [tuple(int(r) for r in row)
            for row in moved.reshape(-1, width)]


def axis_groups(mesh: Mesh, rank: int,
                specs: Sequence[Tuple[str, ...]]) -> List[AxisGroup]:
    """This rank's `AxisGroup` for each tuple of axes in `specs` (a group
    varies those axes and fixes the others).  In a process group of
    several processes every rank must make the same calls in the same
    order, since `torch.distributed.new_group` is collective: each rank
    creates every group of every spec, in one order, and keeps its own.
    A group of one needs no process group."""
    import torch.distributed as dist
    out = []
    for axes in specs:
        mine = None
        for ranks in _group_order(mesh, axes):
            pg = (dist.new_group(list(ranks), backend="gloo")
                  if len(ranks) > 1 and dist.is_initialized() else None)
            if rank in ranks:
                mine = AxisGroup(ranks, ranks.index(rank), pg,
                                 "×".join(axes))
        if mine is None:
            raise ValueError(f"rank {rank} is not in the mesh")
        out.append(mine)
    return out
