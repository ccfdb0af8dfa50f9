"""Serving tier of the port (`singa_tpu/serve/`): the bucketed engine
with checkpoint hot reload, continuous batching over a paged KV cache,
the micro-batcher, and the HTTP and binary-wire front ends, with their
stats, QoS and tenancy vocabulary.

    engine.py     ServeSpec + InferenceEngine: one CUDA graph per
                  (mode, bucket) and, with cb=on, the paged prefill and
                  fixed-slot decode step; load / poll_reload /
                  reload_to copying into the captured params; health()
    kvcache.py    PagedKVCache: block pool, slot tables, null block 0
    scheduler.py  ContinuousScheduler + StreamTicket: admit into a free
                  slot at any decode step, retire on EOS/max-new/
                  deadline
    batcher.py    MicroBatcher + Ticket: deadline-aware admission,
                  brownout and shedding, gathering into buckets; the
                  admission exceptions
    server.py     InferenceServer: warm-up, the batcher and scheduler,
                  the supervised reload poll, stdlib HTTP (/generate,
                  /predict, /healthz, /stats, /metrics, /trace,
                  /admin/reload) and the wire listener
    wire.py       the binary framed transport: codec, FrameReader,
                  TokenRing, LineCoalescer, BinaryTransportServer,
                  BinaryEngineHandle, singa_wire_* counters
    router.py     EngineUnavailable (the Router itself: ROADMAP.md A11)
    stats.py      ServeStats
    qos.py        deadlines, priorities, retry budget, class backoffs
    tenancy.py    TenantRegistry and its quotas

The router, fleet, autoscaler, sessions, traffic generator and the
wire's `NegotiatingEngineHandle` come with ROADMAP.md A11.
"""

from . import qos
from .batcher import (Cancelled, DeadlineExpired, MicroBatcher, Overloaded,
                      Ticket)
from .engine import InferenceEngine, ServeSpec, left_pad
from .kvcache import PagedKVCache
from .qos import PRIORITIES, ClassBackoffs, RetryBudget
from .router import EngineUnavailable
from .scheduler import ContinuousScheduler, StreamTicket
from .server import InferenceServer
from .stats import ServeStats
from .tenancy import TenantBudget, TenantRegistry, TenantSpec
from .wire import (BinaryEngineHandle, BinaryTransportServer, TokenRing,
                   WireError, WireStats, WireUnavailable)

__all__ = ["BinaryEngineHandle", "BinaryTransportServer", "Cancelled",
           "ClassBackoffs", "ContinuousScheduler", "DeadlineExpired",
           "EngineUnavailable", "InferenceEngine", "InferenceServer",
           "MicroBatcher", "Overloaded", "PRIORITIES", "PagedKVCache",
           "RetryBudget", "ServeSpec", "ServeStats", "StreamTicket",
           "TenantBudget", "TenantRegistry", "TenantSpec", "Ticket",
           "TokenRing", "WireError", "WireStats", "WireUnavailable",
           "left_pad", "qos"]
