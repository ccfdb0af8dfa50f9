"""Serving tier of the port (`singa_tpu/serve/`): the bucketed engine
and continuous batching over a paged KV cache, with their stats, QoS
and tenancy vocabulary.

    engine.py     ServeSpec + InferenceEngine: one CUDA graph per
                  (mode, bucket) and, with cb=on, the paged prefill and
                  fixed-slot decode step
    kvcache.py    PagedKVCache: block pool, slot tables, null block 0
    scheduler.py  ContinuousScheduler + StreamTicket: admit into a free
                  slot at any decode step, retire on EOS/max-new/
                  deadline
    batcher.py    the admission exceptions
    stats.py      ServeStats
    qos.py        deadlines, priorities, retry budget, class backoffs
    tenancy.py    TenantRegistry and its quotas

The HTTP server, the binary wire, the MicroBatcher, hot reload and the
router, fleet and autoscaler come with later slices.
"""

from . import qos
from .batcher import Cancelled, DeadlineExpired, Overloaded
from .engine import InferenceEngine, ServeSpec, left_pad
from .kvcache import PagedKVCache
from .qos import PRIORITIES, ClassBackoffs, RetryBudget
from .scheduler import ContinuousScheduler, StreamTicket
from .stats import ServeStats
from .tenancy import TenantBudget, TenantRegistry, TenantSpec

__all__ = ["Cancelled", "ClassBackoffs", "ContinuousScheduler",
           "DeadlineExpired", "InferenceEngine", "Overloaded",
           "PRIORITIES", "PagedKVCache", "RetryBudget", "ServeSpec",
           "ServeStats", "StreamTicket", "TenantBudget", "TenantRegistry",
           "TenantSpec", "left_pad", "qos"]
