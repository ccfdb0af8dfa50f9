"""Host input pipeline: shard reading + background prefetch.

The reference overlaps I/O and compute with a per-executor prefetch
thread and a double-buffered ParserLayer handoff (worker.cc:127-177,
base_layer.h:510-560).  Here a background thread keeps a bounded queue
of ready batches ahead of the device; normalization happens *on device*
inside the train step, so host work is pure file I/O + batching.

Failure semantics (the hardening tier — see docs/FAULT_TOLERANCE.md):
a producer-thread exception is re-raised on the consumer side; a
producer that dies without signaling raises PrefetchError instead of
hanging the trainer (liveness is polled, never assumed); corrupt
records are quarantined — skipped and counted per pass in a shared
PipelineStats — rather than silently dropped or fatally raised.  The
`data.decode` / `data.prefetch` fault-injection sites (utils.faults)
make all three paths testable.

The port's own copy of `singa_tpu/data/pipeline.py`.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..utils.faults import CorruptRecord, maybe_fault
from .records import Record, record_has_image
from .shard import Shard


class PrefetchError(RuntimeError):
    """The prefetch producer died or stalled; the batch stream is
    broken (distinct from StopIteration = clean end of data)."""


class ProducerDied(Exception):
    """Internal signal from `poll_queue`: the producer thread exited
    without a sentinel reaching the consumer.  Callers translate it
    into their own terminal error (PrefetchError / FeedError) after
    checking for a captured producer exception."""


def poll_queue(q: queue.Queue, thread: threading.Thread, poll: float,
               stall: Optional[float], what: str = "prefetch"):
    """Blocking `q.get` with producer-liveness checks — the shared
    consumer side of every bounded producer/consumer handoff in the
    data plane (Prefetcher at batch granularity, data.feed.DeviceFeeder
    at chunk granularity).  Returns the next item; raises ProducerDied
    when the producer thread is gone and the queue is empty (with a
    drain-race re-check, since the sentinel may land between the
    timeout and the liveness probe), or PrefetchError after `stall`
    seconds without an item from a live-but-stuck producer."""
    deadline = (time.monotonic() + stall if stall is not None else None)
    while True:
        try:
            return q.get(timeout=poll)
        except queue.Empty:
            if not thread.is_alive():
                try:
                    return q.get_nowait()
                except queue.Empty:
                    raise ProducerDied
            if deadline is not None and time.monotonic() > deadline:
                raise PrefetchError(
                    f"{what} stalled: no item for {stall:.1f}s "
                    f"(producer alive but stuck — slow or hung "
                    f"source)")


@dataclass
class PipelineStats:
    """Shared counters between a batch source, its Prefetcher, and the
    consumer (trainer/supervisor) — chiefly the quarantine tally of
    corrupt records skipped instead of crashing the run."""
    quarantined: int = 0        # total corrupt records skipped
    quarantined_pass: int = 0   # within the current read pass
    passes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def quarantine(self, n: int = 1) -> None:
        with self._lock:
            self.quarantined += n
            self.quarantined_pass += n

    def end_pass(self) -> int:
        """Close the current pass; returns (and resets) its quarantine
        count so sources can log once per pass."""
        with self._lock:
            n = self.quarantined_pass
            self.quarantined_pass = 0
            self.passes += 1
            return n

    def register_into(self, registry,
                      prefix: str = "singa_data") -> None:
        """Register these counters into an `obs.MetricsRegistry` as a
        pull-time collector — additive; existing semantics untouched."""
        from ..obs.metrics import Sample

        def collect():
            with self._lock:
                q, p = self.quarantined, self.passes
            return [
                Sample(f"{prefix}_quarantined_total", "counter",
                       "corrupt records skipped instead of crashing",
                       float(q)),
                Sample(f"{prefix}_passes_total", "counter",
                       "completed read passes over the source",
                       float(p)),
            ]

        registry.register_collector(collect)


def _decode_batch(vals: List[bytes], data_layer: str) -> Dict:
    """Decode a batch of serialized records — native C++ batch decoder
    when built (one memcpy per record), Python codec otherwise.  Callers
    filter image-less records before batching (record_has_image), so
    every val here contributes one batch row."""
    from . import native
    fast = native.decode_image_batch(vals)
    if fast is not None:
        pixels, labels = fast
        return {data_layer: {"pixel": pixels, "label": labels}}
    pixels, labels = [], []
    for val in vals:
        rec = Record.decode(val)
        pixels.append(rec.image.pixels_array())
        labels.append(rec.image.label)
    return {data_layer: {"pixel": np.stack(pixels),
                         "label": np.asarray(labels, np.int32)}}


def _quarantine_pass_report(source: str, stats: PipelineStats) -> None:
    n = stats.end_pass()
    if n:
        import sys
        print(f"warning: quarantined {n} corrupt record(s) in one pass "
              f"over {source} ({stats.quarantined} total)",
              file=sys.stderr)


def lmdb_batches(path: str, batchsize: int, data_layer: str = "data",
                 loop: bool = True, random_skip: int = 0,
                 seed: int = 0,
                 stats: Optional[PipelineStats] = None) -> Iterator[Dict]:
    """Batches straight from an LMDB environment of caffe Datum values
    (kLMDBData semantics, layer.cc:237-328): B-tree key order, Datum →
    Record conversion, same random_skip contract as shard_batches.
    For production throughput convert once with
    `tools/loader.py convert-lmdb` (shards get the native batch
    decoder); this path exists so reference configs pointing at an
    LMDB env train unchanged."""
    from .lmdb_reader import iter_lmdb
    from .records import Datum, record_from_datum

    stats = stats if stats is not None else PipelineStats()
    rng = np.random.default_rng(seed)
    # [0, random_skip-1], the reference's rand() % random_skip_
    # contract (layer.cc:651-653)
    skip = rng.integers(0, random_skip) if random_skip else 0
    # partial batches CARRY across epoch boundaries in loop mode (an
    # env smaller than the batch still fills batches over several
    # passes instead of silently dropping its records every epoch)
    vals: List[bytes] = []
    warned = [False]
    while True:
        usable = skipped = seen = 0
        for _, raw in iter_lmdb(path):
            seen += 1
            if skip > 0:
                skip -= 1
                skipped += 1
                continue
            try:
                maybe_fault("data.decode")
                d = Datum.decode(raw)
            except (ValueError, IndexError, CorruptRecord):
                # a single rotten Datum must not kill a million-record
                # pass; quarantine it (counted, reported per pass)
                stats.quarantine()
                continue
            # NOT quarantined: a *valid* Datum this build cannot use
            # (e.g. JPEG-encoded) is a config error and fails loud
            rec = record_from_datum(d)
            if rec.image is None or not (rec.image.pixel
                                         or rec.image.data):
                continue
            usable += 1
            vals.append(rec.encode())
            if len(vals) == batchsize:
                yield _decode_batch(vals, data_layer)
                vals = []
        _quarantine_pass_report(f"LMDB environment {path!r}", stats)
        _pass_end_guard(f"LMDB environment {path!r}", loop, usable,
                        skipped, seen, warned)
        if not loop:
            if vals:
                yield _decode_batch(vals, data_layer)
            return


def _pass_end_guard(source: str, loop: bool, usable: int, skipped: int,
                    seen: int, warned_skip: List[bool]) -> None:
    """Shared loop-mode sanity for a completed read pass (lmdb_batches
    and shard_batches both): a pass with records but no skips and no
    usable rows means an empty/imageless source — raise instead of
    spinning hot forever; a pass consumed ENTIRELY by random_skip is
    legal (the leftover skip carries) but a skip that large is almost
    always a config mistake, so warn ONCE about the silent extra
    passes.  A mixed pass (some skips, rest imageless) neither warns
    nor raises yet — once the skip budget exhausts, a later pass hits
    the raise with the accurate message."""
    if not loop:
        return
    if not usable and not skipped:
        raise ValueError(
            f"{source} contains no usable image records")
    if not usable and skipped == seen and seen and not warned_skip[0]:
        warned_skip[0] = True
        import sys
        print(f"warning: random_skip consumed an entire pass over "
              f"{source} ({skipped} records) — a skip larger than the "
              f"dataset costs a full extra scan per multiple before "
              f"the first batch", file=sys.stderr)


def shard_batches(folder: str, batchsize: int, data_layer: str = "data",
                  loop: bool = True, random_skip: int = 0,
                  seed: int = 0,
                  stats: Optional[PipelineStats] = None) -> Iterator[Dict]:
    """Batches from a shard folder of Record tuples, in file order
    (ShardData semantics, layer.cc:646-673 incl. random_skip).  Records
    whose bytes fail the tag-walk (torn mid-file writes the append-scan
    cannot truncate) are quarantined into `stats`, not raised — the
    shard's own torn-TAIL recovery already ran at open."""
    stats = stats if stats is not None else PipelineStats()
    rng = np.random.default_rng(seed)
    # [0, random_skip-1], the reference's rand() % random_skip_
    # contract (layer.cc:651-653)
    skip = rng.integers(0, random_skip) if random_skip else 0
    # partial batches carry across epoch boundaries in loop mode (a
    # shard smaller than the batch still fills batches over passes)
    vals: List[bytes] = []
    warned = [False]
    while True:
        shard = Shard(folder, Shard.KREAD)
        usable = skipped = seen = 0
        try:
            for i, (_, val) in enumerate(shard):
                seen += 1
                if skip > 0:
                    skip -= 1
                    skipped += 1
                    continue
                try:
                    maybe_fault("data.decode")
                    has_image = record_has_image(val)
                except (ValueError, CorruptRecord):
                    stats.quarantine()
                    continue
                if not has_image:
                    continue   # type-only records contribute no batch row
                usable += 1
                vals.append(val)
                if len(vals) == batchsize:
                    yield _decode_batch(vals, data_layer)
                    vals = []
        finally:
            # an abandoned generator (consumer dropped mid-pass) must
            # not leak the file handle
            shard.close()
        _quarantine_pass_report(f"shard folder {folder!r}", stats)
        _pass_end_guard(f"shard folder {folder!r}", loop, usable,
                        skipped, seen, warned)
        if not loop:
            if vals:  # final partial batch
                yield _decode_batch(vals, data_layer)
            return


class Prefetcher:
    """Bounded background prefetch (the reference's prefetch thread,
    worker.cc:163-177, generalized to a queue depth).

    Failure contract:
    - an exception in the producer thread is re-raised on the consumer
      side (a corrupt source must not look like a clean end of data);
    - the consumer polls with a timeout and checks producer liveness,
      so a producer that died without signaling raises PrefetchError
      instead of hanging the trainer forever; `stall_timeout` bounds
      the wait on a live-but-stuck producer (None = unbounded);
    - `close()` (also driven by `__del__` and iterator drop) stops the
      producer and drains the queue so the daemon thread exits instead
      of blocking on a full queue for the life of the process;
    - an injected CorruptRecord at the `data.decode` site is
      quarantined into `stats` (the batch stream continues, in order).
    """

    _END = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 poll_timeout: float = 0.5,
                 stall_timeout: Optional[float] = None,
                 stats: Optional[PipelineStats] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._err: Optional[BaseException] = None
        self._done = False
        self._poll = max(poll_timeout, 0.01)
        self._stall = stall_timeout
        self.stats = stats if stats is not None else PipelineStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that still honors close(): gives up when the
        consumer asked us to stop (the queue may be full forever)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._poll)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                try:
                    maybe_fault("data.decode")
                except CorruptRecord:
                    # the bad record is consumed and counted; the next
                    # good one takes its slot, order preserved
                    self.stats.quarantine()
                    continue
                try:
                    item = next(self._it)
                except StopIteration:
                    break
                if not self._put(item):
                    return   # closed: no sentinel needed, nobody reads
        except BaseException as e:  # re-raised on the consumer thread —
            self._err = e           # a corrupt source must not look like
        finally:                    # a clean end of data
            self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:           # terminal: never block on the dead queue
            if self._err is not None:
                raise self._err
            raise StopIteration
        maybe_fault("data.prefetch")
        try:
            item = poll_queue(self._q, self._thread, self._poll,
                              self._stall, what="prefetch")
        except ProducerDied:
            self._done = True
            if self._err is not None:
                raise self._err
            raise PrefetchError(
                "prefetch producer thread died without "
                "signaling end of data")
        if item is self._END:
            self._done = True
            return self.__next__()
        return item

    def close(self) -> None:
        """Stop the producer and release its thread.  Safe to call
        multiple times and from __del__."""
        self._stop.set()
        # unblock a producer waiting on a full queue
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


def prefetch(it: Iterator, depth: int = 2,
             stats: Optional[PipelineStats] = None,
             stall_timeout: Optional[float] = None) -> Prefetcher:
    return Prefetcher(it, depth, stats=stats, stall_timeout=stall_timeout)
