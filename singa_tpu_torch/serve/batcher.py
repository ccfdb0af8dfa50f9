"""Serving-tier request failures: the exceptions admission and dispatch
raise to callers (`singa_tpu/serve/batcher.py:48-66`).

`ContinuousScheduler` (serve/scheduler.py) raises all three.  The
deadline-aware `MicroBatcher` and its `Ticket`, which coalesce queued
requests into the engine's buckets, come with the port of the serving
front ends (the HTTP server and the binary wire); until then callers
pad and run a bucket through `InferenceEngine.answer`.
"""

from __future__ import annotations


class Overloaded(RuntimeError):
    """Admission rejected; retry after `retry_after` seconds."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it was dispatched.  With
    end-to-end propagation (serve/qos.py) this includes dead on
    arrival: the remaining budget was already <= 0 at admission."""


class Cancelled(RuntimeError):
    """The caller cancelled the request (a hedge's losing attempt):
    dropped from the queue / retired from its slot, counted
    `cancelled` — never `failed`, never a strike."""
