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
of one).  The port runs the data axis (`parallel/partition.py`); the
other axes are ROADMAP.md A9 (`unported_axes` names them).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..config.schema import ClusterConfig

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


def unported_axes(cluster: Optional[ClusterConfig],
                  net_partition_type: str = "kNone") -> Dict[str, int]:
    """The axes other than `data` that `cluster` asks to be above 1
    (tensor, pipeline, sequence and expert parallelism, and
    kLayerPartition over a group of several executors), by name: what
    the port cannot run yet (ROADMAP.md A9)."""
    if cluster is None:
        return {}
    out = {name: int(v) for name, v in (
        ("tensor_parallel", cluster.tensor_parallel),
        ("pipeline_parallel", cluster.pipeline_parallel),
        ("sequence_parallel", cluster.sequence_parallel),
        ("expert_parallel", cluster.expert_parallel)) if (v or 1) > 1}
    group_size = cluster.nprocs_per_group * cluster.nthreads_per_procs
    if (net_partition_type == "kLayerPartition" and group_size > 1
            and not any((cluster.data_parallel, cluster.tensor_parallel,
                         cluster.pipeline_parallel,
                         cluster.sequence_parallel,
                         cluster.expert_parallel))):
        out["kLayerPartition group_size"] = group_size
    return out
