"""Parallelism of the port (`singa_tpu/parallel/`): the multi-process
bootstrap on `torch.distributed` (`bootstrap.py`: `distributed_init`,
`coordinator_address`, `parse_hostfile`), the process mesh and its
subgroups (`mesh.py`), the collectives of an axis (`comm.py`), the
partitioner's data, model and seq axes (`partition.py`: `shard_batch`,
`param_shardings`, `pad_params`, `shard_params`, `shard_opt_state`,
`DataParallel`), ring and Ulysses attention (`sequence.py`), pipeline
parallelism (`pipeline.py`: `pipeline_apply`, `pipeline_apply_hetero`,
`stack_stage_params`; `pipeline_net.py`: `PipelineNet`,
`HeteroPipelineNet`, `stage_assignment`), and the elastic tier
(`elastic.py`: EASGD, RandomSync, `ElasticController`, `ReplicaSet`,
and `DistributedReplicaSet` over the process group), exported lazily as
the JAX package exports it.  Expert parallelism lives in kMoE
(`ops/moe.py`) over the mesh's expert axis.
"""

from .bootstrap import (DEFAULT_PORT, coordinator_address, distributed_init,
                        parse_hostfile)
from .mesh import AXES, Mesh, make_mesh, mesh_from_cluster
from .partition import (DataParallel, pad_params, param_shardings,
                        shard_batch, shard_opt_state, shard_params)
from .pipeline import (pipeline_apply, pipeline_apply_hetero,
                       stack_stage_params)
from .sequence import ring_attention, ulysses_attention

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
