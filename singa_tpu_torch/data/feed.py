"""Overlapped host-to-device feed for the chunked train loop.

Port of `singa_tpu/data/feed.py` on pinned host buffers and CUDA
streams.  It sits between `Prefetcher` (host batches) and the trainer's
chunked loop (`Trainer.run(scan_chunk=...)`):

    source → Prefetcher → DeviceFeeder → train_steps
             (batches)    (staged chunks on the device)

`ChunkStager` stacks a list of host batches (nested dicts of numpy
arrays or CPU tensors) into reusable staging buffers and copies the
stacked chunk to the device.  On CUDA the buffers are pinned and the
copy is asynchronous: it is issued on the stager's stream (the caller's
current stream by default, a side stream inside a `DeviceFeeder`) and
followed by a CUDA event.  The consumer calls `FeedChunk.take()`, which
makes its current stream wait on that event and marks the chunk's device
tensors as used there (`record_stream`), so the allocator does not hand
them out again before the chunk's steps have run.  A set of staging
buffers is written again only after the event of the copy made from it
has completed.

`DeviceFeeder` runs a stager on a background thread over a deterministic
chunk plan (the exact (start_step, length) sequence the loop consumes,
`Trainer._chunk_plan`), keeping `depth` staged chunks ahead: chunk k+1
is on the device while chunk k's steps run.  It rotates `depth + 2`
buffer sets, as the JAX stager does: at most `depth` chunks queued, one
in the consumer's hands and one being staged, so the set staged next has
always been handed over and its copy is, in practice, long done.

Leaves keep the JAX package's dtypes: float64 becomes float32 and int64
becomes int32, as `jax.dtypes.canonicalize_dtype` makes them, so
`--feeder on` and `--feeder off` (which stages inline through the same
stager) give bit-equal trajectories.  The JAX module's deliberately
misaligned `staging_buffer` defeats XLA's zero-copy aliasing of host
buffers; a torch copy from a pinned buffer never aliases it, so it has
no counterpart here.

Failure contract, as the JAX module's: a producer-thread exception
re-raises on `get()` (the `feed.stage` fault site included, so the
Supervisor's restore-and-replay covers the async path); a producer that
dies without signaling raises `FeedError` instead of hanging; `close()`
stops the thread without closing the upstream iterator.  The feeder
consumes exactly one batch per step, in order, so the Supervisor's
fast-forward by step is unchanged.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import (Any, Iterable, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from .. import obs
from ..utils.faults import maybe_fault
from .pipeline import PrefetchError, ProducerDied, poll_queue

# the JAX package's default (x64 off) canonical dtypes
_CANONICAL = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.complex128): np.dtype(np.complex64)}


class FeedError(PrefetchError):
    """The feed producer died, stalled, or delivered a chunk that does
    not match the consumer's plan (distinct from StopIteration = the
    plan — or the upstream data — ran out cleanly)."""


class FeedChunk(NamedTuple):
    """One staged chunk: `batches` carries a leading `length` step axis
    on every leaf and lives on the stager's device; on CUDA `ready` is
    the event of its copy."""
    start: int
    length: int
    batches: Any
    ready: Optional[Any] = None

    def take(self):
        """The batches, safe to read on the current stream: it waits on
        the copy's event, and the device tensors are marked as used on
        it."""
        if self.ready is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.ready)
            for t in _leaves(self.batches):
                t.record_stream(stream)
        return self.batches


def _paths(tree, prefix=()) -> List[Tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _unflatten(paths, values):
    out: dict = {}
    for path, v in zip(paths, values):
        if not path:
            return v
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ChunkStager:
    """Stacks host batches into reusable staging buffers and places the
    chunk on `device`.

    `capacity` pre-sizes the leading axis (the loop's scan_chunk);
    shorter chunks use a view of the same buffers, so steady state
    allocates no host memory.  On CUDA the buffers are pinned and the
    copy runs on `stream` (the caller's current stream when None) with
    an event after it; `rotate` buffer sets take turns, and a set is
    overwritten only after its last copy's event has completed."""

    def __init__(self, device, capacity: int = 0, rotate: int = 1,
                 stream=None):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = stream
        self._capacity = max(int(capacity), 0)
        self._rotate = max(int(rotate), 1)
        self._sets: List[Optional[List[torch.Tensor]]] = \
            [None] * self._rotate
        self._events: List[Optional[Any]] = [None] * self._rotate
        self._turn = 0
        self._paths = None

    def _alloc(self, first: List[np.ndarray], n: int) -> List[torch.Tensor]:
        cap = max(self._capacity, n)
        bufs = []
        for leaf in first:
            dt = _CANONICAL.get(leaf.dtype, leaf.dtype)
            t = torch.from_numpy(np.empty((cap,) + leaf.shape, dt))
            bufs.append(t.pin_memory() if self._cuda else t)
        return bufs

    def stage(self, batches: List[Any]) -> FeedChunk:
        """Stack `batches` (nested dicts with identical structure) along a
        new leading axis and place the result on the device; returns an
        unnumbered `FeedChunk` (start 0)."""
        fault = maybe_fault("feed.stage")
        if fault == "torn":
            # torn has no meaning for an in-memory stage (nothing is
            # half-written anywhere durable); treat as a no-op
            fault = None
        n = len(batches)
        if n == 0:
            raise ValueError("cannot stage an empty chunk")
        paths = _paths(batches[0])
        rows = [[_host(_get(b, p)) for p in paths] for b in batches]
        if paths != self._paths:
            self._paths = paths
            self._sets = [None] * self._rotate
            self._events = [None] * self._rotate
        i = self._turn
        self._turn = (i + 1) % self._rotate
        bufs = self._sets[i]
        if (bufs is None or n > bufs[0].shape[0]
                or any(tuple(b.shape[1:]) != l.shape
                       for b, l in zip(bufs, rows[0]))):
            bufs = self._sets[i] = self._alloc(rows[0], n)
            self._events[i] = None
        if self._events[i] is not None:
            # the copy made from this set a rotation ago must be done
            # before its buffers are overwritten
            self._events[i].synchronize()
            self._events[i] = None
        for j, buf in enumerate(bufs):
            host = buf.numpy()
            for k, row in enumerate(rows):
                np.copyto(host[k, ...], row[j], casting="same_kind")
        if not self._cuda:
            # the consumer reads these views before the set comes round
            # again (see DeviceFeeder): no copy needed on the CPU
            return FeedChunk(0, n, _unflatten(paths, [b[:n] for b in bufs]))
        stream = self._stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            placed = [b[:n].to(self.device, non_blocking=True) for b in bufs]
            ev = torch.cuda.Event()
            ev.record(stream)
        self._events[i] = ev
        return FeedChunk(0, n, _unflatten(paths, placed), ev)


class DeviceFeeder:
    """Background staging thread: stages chunks of an iterator per a
    deterministic `plan` and hands them over a bounded queue.

    `plan` is an iterable of (start_step, length) descriptors, the same
    sequence the consumer computes (`Trainer._chunk_plan`).  `get()`
    blocks for the next chunk with producer-liveness polling; after the
    plan is exhausted it raises StopIteration.  On CUDA the copies run
    on a stream of the feeder's own.

    `pull_seconds` / `stage_seconds` accumulate producer-thread time
    split between waiting on the upstream iterator and stacking plus
    issuing the copy; the trainer reports `stage_seconds` as its `stage`
    phase (off the critical path; the consumer only blocks in `get`,
    reported as `wait`)."""

    _END = object()

    def __init__(self, it: Iterator, plan: Iterable[Tuple[int, int]],
                 device, depth: int = 2, capacity: int = 0,
                 poll_timeout: float = 0.5,
                 stall_timeout: Optional[float] = None):
        self._it = it
        self._plan = iter(plan)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        stream = (torch.cuda.Stream(device=device)
                  if device.type == "cuda" else None)
        self._stager = ChunkStager(device, capacity=capacity,
                                   rotate=max(depth, 1) + 2, stream=stream)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._done = False
        self._poll = max(poll_timeout, 0.01)
        self._stall = stall_timeout
        self.pull_seconds = 0.0
        self.stage_seconds = 0.0
        self.chunks_staged = 0
        # producer-thread spans carry the consumer's correlation id
        # (span stacks are per thread)
        self._corr = obs.current_corr()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._poll)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            for start, n in self._plan:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                with obs.span("feeder.pull", corr=self._corr,
                              start=start, steps=n):
                    batches = []
                    for _ in range(n):
                        batches.append(next(self._it))
                t1 = time.perf_counter()
                with obs.span("feeder.stage", corr=self._corr,
                              start=start, steps=n):
                    staged = self._stager.stage(batches)
                t2 = time.perf_counter()
                self.pull_seconds += t1 - t0
                self.stage_seconds += t2 - t1
                self.chunks_staged += 1
                if not self._put(staged._replace(start=start)):
                    return   # closed: nobody reads, no sentinel needed
        except BaseException as e:    # re-raised on the consumer thread
            self._err = e             # (incl. injected feed.stage faults
        finally:                      # and upstream StopIteration)
            self._put(self._END)

    # -- consumer ----------------------------------------------------------
    def get(self) -> FeedChunk:
        """Next staged chunk; blocks with liveness polling.  Raises the
        producer's error, StopIteration after a clean end of plan, or
        FeedError for a dead/stalled producer."""
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        try:
            item = poll_queue(self._q, self._thread, self._poll,
                              self._stall, what="feed")
        except ProducerDied:
            self._done = True
            if self._err is not None:
                raise self._err
            raise FeedError("feed producer thread died without "
                            "signaling end of plan")
        if item is self._END:
            self._done = True
            return self.get()
        return item

    def close(self) -> None:
        """Stop the producer and release its thread.  Idempotent; does
        NOT close the upstream iterator."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        t = getattr(self, "_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def __del__(self):  # pragma: no cover — GC timing
        try:
            self.close()
        except Exception:
            pass
