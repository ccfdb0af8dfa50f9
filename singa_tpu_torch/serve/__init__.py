"""Serving tier of the port (`singa_tpu/serve/`): the bucketed engine
with checkpoint hot reload, continuous batching over a paged KV cache,
the micro-batcher, the HTTP and binary-wire front ends, and the control
plane over many engines (router, fleet, rollout, autoscaler, failover
sessions and their WAL), with their stats, QoS and tenancy vocabulary.

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
                  BinaryEngineHandle, NegotiatingEngineHandle (HTTP
                  with an upgrade to the wire), singa_wire_* counters
    router.py     Router + engine handles (in-process, HTTP): least-
                  loaded healthy dispatch, retry with strikes,
                  quarantine and readmission, shedding, hedging,
                  brownout, tenancy, mid-stream failover, lame duck
    session.py    StreamSession + SessionManager: the decode journal
                  behind mid-stream failover
    sessionlog.py SessionWal + ControlStateStore: the session WAL,
                  control-state snapshots, epoch fencing
    fleet.py      EngineFleet + RolloutController + FleetServer: N
                  pinned engines behind a Router, canary rollout,
                  elastic grow/retire, handoff and standby
    autoscale.py  AutoScaler + AutoScaleSpec: the SLO-driven control
                  loop over the fleet
    traffic.py    TrafficGen + Phase scenarios: open-loop load and
                  chaos legs
    stats.py      ServeStats
    qos.py        deadlines, priorities, retry budget, class backoffs
    tenancy.py    TenantRegistry and its quotas
"""

from . import qos
from .autoscale import AutoScaler, AutoScaleSpec
from .batcher import (Cancelled, DeadlineExpired, MicroBatcher, Overloaded,
                      Ticket)
from .engine import InferenceEngine, ServeSpec, left_pad
from .fleet import EngineFleet, FleetServer, RolloutController, RolloutSpec
from .kvcache import PagedKVCache
from .qos import PRIORITIES, ClassBackoffs, RetryBudget
from .router import (EngineUnavailable, HttpEngineHandle, LameDuck,
                     LocalEngineHandle, Router, RouterSpec, RouterStats,
                     UnknownModel, UnknownSession)
from .scheduler import ContinuousScheduler, StreamTicket
from .server import InferenceServer
from .session import SessionManager, StreamSession, StreamStats
from .sessionlog import (ControlStateStore, SessionWal, WalStats,
                         reduce_sessions, replay_wal, walcheck)
from .stats import ServeStats
from .tenancy import TenantBudget, TenantRegistry, TenantSpec
from .traffic import (Phase, TrafficGen, diurnal, flash_crowd, kill_chaos,
                      ramp, stall_chaos, steady)
from .wire import (BinaryEngineHandle, BinaryTransportServer,
                   NegotiatingEngineHandle, TokenRing, WireError,
                   WireStats, WireUnavailable)

__all__ = ["AutoScaleSpec", "AutoScaler", "BinaryEngineHandle",
           "BinaryTransportServer", "Cancelled", "ClassBackoffs",
           "ContinuousScheduler", "ControlStateStore", "DeadlineExpired",
           "EngineFleet", "EngineUnavailable", "FleetServer",
           "HttpEngineHandle", "InferenceEngine", "InferenceServer",
           "LameDuck", "LocalEngineHandle", "MicroBatcher",
           "NegotiatingEngineHandle", "Overloaded", "PRIORITIES",
           "PagedKVCache", "Phase", "RetryBudget", "RolloutController",
           "RolloutSpec", "Router", "RouterSpec", "RouterStats",
           "ServeSpec", "ServeStats", "SessionManager", "SessionWal",
           "StreamSession", "StreamStats", "StreamTicket", "TenantBudget",
           "TenantRegistry", "TenantSpec", "Ticket", "TokenRing",
           "TrafficGen", "UnknownModel", "UnknownSession", "WalStats",
           "WireError", "WireStats", "WireUnavailable", "diurnal",
           "flash_crowd", "kill_chaos", "left_pad", "qos", "ramp",
           "reduce_sessions", "replay_wal", "stall_chaos", "steady",
           "walcheck"]
