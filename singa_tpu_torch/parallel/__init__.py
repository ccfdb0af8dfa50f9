"""Multi-replica pieces of the port (`singa_tpu/parallel/`): the hostfile
parser, for `serve.fleet.EngineFleet.from_hostfile`, and the in-process
elastic tier (`elastic.py`: EASGD, RandomSync, `ElasticController`,
`ReplicaSet`), exported lazily as the JAX package exports it.  Meshes,
partitioning, pipeline and sequence parallelism and
`DistributedReplicaSet` are ROADMAP.md A9.
"""

from .bootstrap import parse_hostfile

_LAZY = {
    "ElasticController": ("elastic", "ElasticController"),
    "ReplicaSet": ("elastic", "ReplicaSet"),
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
