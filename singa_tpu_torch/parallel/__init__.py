"""Parallelism of the port (`singa_tpu/parallel/`): the multi-process
bootstrap on `torch.distributed` (`bootstrap.py`: `distributed_init`,
`coordinator_address`, `parse_hostfile`), the process mesh
(`mesh.py`), the data axis of the partitioner (`partition.py`:
`shard_batch`, `DataParallel`), and the elastic tier (`elastic.py`:
EASGD, RandomSync, `ElasticController`, `ReplicaSet`, and
`DistributedReplicaSet` over the process group), exported lazily as the
JAX package exports it.  Tensor, pipeline, sequence and expert
parallelism are ROADMAP.md A9.
"""

from .bootstrap import (DEFAULT_PORT, coordinator_address, distributed_init,
                        parse_hostfile)
from .mesh import AXES, Mesh, make_mesh, mesh_from_cluster
from .partition import DataParallel, shard_batch

_LAZY = {
    "ElasticController": ("elastic", "ElasticController"),
    "ReplicaSet": ("elastic", "ReplicaSet"),
    "DistributedReplicaSet": ("elastic", "DistributedReplicaSet"),
    "elastic_update": ("elastic", "elastic_update"),
    "randomsync_update": ("elastic", "randomsync_update"),
    "sync_sample_ratio": ("elastic", "sync_sample_ratio"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
