"""Zero-copy binary transport for the serving hot path: persistent
framed connections, shared-memory token rings, and batched token
flushes.

Every hop used to cross stdlib HTTP with one JSON chunk per decoded
token and one fresh TCP connection per request — fine at dozens of
requests, a wall at fleet scale.  "RPC Considered Harmful" (arxiv
1805.08430) is the playbook applied here: persistent connections,
explicit length-prefixed framing, and no boxed per-message
serialization on the per-token path.  HTTP/JSON stays as the
always-on debug surface; the binary transport is a negotiated upgrade
(the JAX package's `NegotiatingEngineHandle`) that degrades back to
HTTP on any transport-level failure — counted, never a lost request.

The port's own copy of `singa_tpu/serve/wire.py`, JAX-free there too:
the codec, `FrameReader`, `TokenRing`, `LineCoalescer`, `WireStats`,
the engine side (`BinaryTransportServer`) and the client
(`BinaryEngineHandle`), byte for byte the same protocol, so either
package's handle drives the other's server.  `NegotiatingEngineHandle`
wraps the Router's `HttpEngineHandle` and comes with the Router
(ROADMAP.md A11).

Frame layout (all little-endian)::

    +----+----+-----+------+------+--------+------------+-------------+
    |magic|ver|kind |flags | rsv  | req_id | header_len | payload_len |
    | 2B  |1B | 1B  | 1B   | 1B   |  u32   |    u16     |    u32      |
    +----+----+-----+------+------+--------+------------+-------------+
    | QoS header (REQ only): deadline_ms i64, priority u8,            |
    |   resume_from u32, parent_span u64, then tenant / trace id /    |
    |   session id as u16-length-prefixed strings                     |
    +------------------------------------------------------------------+
    | payload (kind-specific flat struct or JSON, below)               |
    +------------------------------------------------------------------+

The QoS header is the complete wire envelope of the HTTP headers —
deadline (X-Deadline-Ms), priority (X-Priority),
tenant (X-Tenant), trace/parent ids (X-Trace-Id / X-Parent-Span),
session id (X-Session-Id, reserved at the engine tier) and
resume_from — designed once, mapped both ways by serve/qos.py so the
two wire surfaces can never drift.

Frame kinds:

    HELLO   connection handshake, both directions (empty payload; the
            preamble's version byte is the negotiation)
    REQ     one request: op u8 (generate|predict|stream|probe|stats|
            reload), timeout_ms i64, max_new i32, step i32, n_tokens
            u32, then the prompt as raw int32s
    RESULT  unary reply: JSON body (predict logprobs etc. — once per
            request, not per token)
    TOKENS  one flushed batch of decoded tokens: first_i u32, count
            u32, then raw int32 token ids — NO per-token objects; the
            sender gather-writes the token ring's memoryview straight
            into the socket
    DONE    stream terminal: JSON summary line (once per stream)
    ERR     mapped failure: code u8, retry_after_ms u32, utf-8
            message (the status-code vocabulary of the HTTP surface)
    CANCEL  client abandons req_id (hedge loser, closed generator)

Malformed input (bad magic, version skew, oversized length prefix,
truncated frame) is an honest counted error (`wire_malformed_total`)
and a closed connection — never a hang, never a crash, never a
partially-trusted payload.

Decode tokens are flushed in batched frames under the
`flush_tokens`/`flush_ms` knobs (ServeSpec for engine servers,
the JAX RouterSpec for the fleet frontend): a flush goes out when
`flush_tokens` tokens are buffered or `flush_ms` has passed since the
batch opened — and the FIRST token of a stream always flushes
immediately, so first-token latency (a gated stage) never pays for
batching.  The same knobs batch the HTTP ndjson paths (one chunk
carrying several lines), so both surfaces share one flush story.

`singa_wire_*` metrics split serialization time out of the stage
taxonomy: `ser/deser_seconds_total` for the binary codec,
`json_ser/json_deser_seconds_total` for the JSON surface — the
A/B proof of where the binary surface saves time.  Fault site
`wire.frame` (utils/faults.py) drops, corrupts, or tears one outbound
frame; all three degrade to a counted reconnect
or a per-request failure the Router's retry/failover machinery
absorbs.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from itertools import count as _it_count
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils import faults
from . import qos
from .batcher import Cancelled, DeadlineExpired, Overloaded
from .router import EngineUnavailable

MAGIC = b"SW"
VERSION = 1

#: frame kinds
K_HELLO, K_REQ, K_RESULT, K_TOKENS, K_DONE, K_ERR, K_CANCEL = \
    range(1, 8)
KIND_NAMES = {K_HELLO: "hello", K_REQ: "req", K_RESULT: "result",
              K_TOKENS: "tokens", K_DONE: "done", K_ERR: "err",
              K_CANCEL: "cancel"}

#: request ops
OP_GENERATE, OP_PREDICT, OP_STREAM, OP_PROBE, OP_STATS, OP_RELOAD = \
    range(1, 7)
_OP_NAMES = {OP_GENERATE: "generate", OP_PREDICT: "predict",
             OP_STREAM: "stream", OP_PROBE: "probe",
             OP_STATS: "stats", OP_RELOAD: "reload"}

#: error codes — the frame twin of the HTTP status mapping
E_UNAVAILABLE, E_OVERLOADED, E_DEADLINE, E_BADREQ, E_CANCELLED, \
    E_INTERNAL = range(1, 7)

#: hostile-input bounds: a garbage length prefix must never allocate
MAX_HEADER_LEN = 1 << 12
MAX_PAYLOAD_LEN = 1 << 26

_PREAMBLE = struct.Struct("<2sBBBBIHI")     # magic ver kind flags rsv
                                            # req_id hlen plen
_QOS_HDR = struct.Struct("<qBIQ")           # deadline_ms prio
                                            # resume_from parent_span
_REQ_HDR = struct.Struct("<BqiiI")          # op timeout_ms max_new
                                            # step n_tokens
_TOK_HDR = struct.Struct("<II")             # first_i count
_ERR_HDR = struct.Struct("<BI")             # code retry_after_ms
_STR_LEN = struct.Struct("<H")

_I32_NONE = -(1 << 31)                      # "no step" sentinel


class WireError(RuntimeError):
    """A malformed frame: bad magic, version skew, oversized length
    prefix, or a truncation mid-frame.  The connection that produced
    it is closed — a peer that frames wrong once cannot be trusted to
    frame right next time."""


class WireUnavailable(RuntimeError):
    """A TRANSPORT-level failure on the binary path (connect refused,
    handshake failed, connection died before the reply) — distinct
    from an engine-reported error so `NegotiatingEngineHandle` knows
    when falling back to HTTP can actually help."""


# -- metrics -----------------------------------------------------------------

class WireStats:
    """Binary-transport counters, exported as `singa_wire_*_total`
    (the WalStats mold) plus the serialization-time split the
    transport A/B gates on."""

    FIELDS = ("frames_tx", "frames_rx", "bytes_tx", "bytes_rx",
              "tokens_tx", "token_flushes", "malformed", "reconnects",
              "fallbacks", "faulted_frames", "conns_opened",
              "conns_closed", "cancels_tx")
    #: nanosecond accumulators exported as *_seconds_total
    NS_FIELDS = ("ser_ns", "deser_ns", "json_ser_ns", "json_deser_ns")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS + self.NS_FIELDS:
            setattr(self, f, 0)

    def count(self, fieldname: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, fieldname, getattr(self, fieldname) + n)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
            for f in self.NS_FIELDS:
                out[f.replace("_ns", "_seconds")] = \
                    getattr(self, f) / 1e9
            return out

    def register_into(self, registry,
                      prefix: str = "singa_wire") -> None:
        from ..obs.metrics import Sample

        def collect():
            snap = self.snapshot()
            out = [Sample(f"{prefix}_{k}_total", "counter",
                          f"binary transport counter {k!r}",
                          float(snap[k])) for k in self.FIELDS]
            for f in self.NS_FIELDS:
                k = f.replace("_ns", "_seconds")
                out.append(Sample(
                    f"{prefix}_{k}_total", "counter",
                    f"cumulative {k.replace('_', ' ')} on the "
                    f"serving wire", float(snap[k])))
            return out

        registry.register_collector(collect)


#: process-wide default — every transport endpoint in this process
#: shares one serialization/malformed story, exactly like obs.perf
STATS = WireStats()


def timed_json_dumps(obj, stats: Optional[WireStats] = None) -> bytes:
    """json.dumps with the time charged to the wire's JSON
    serialization split (the HTTP ndjson hot path)."""
    t0 = time.perf_counter_ns()
    data = json.dumps(obj).encode()
    (stats or STATS).count("json_ser_ns",
                           time.perf_counter_ns() - t0)
    return data


def timed_json_loads(data, stats: Optional[WireStats] = None):
    t0 = time.perf_counter_ns()
    out = json.loads(data)
    (stats or STATS).count("json_deser_ns",
                           time.perf_counter_ns() - t0)
    return out


# -- QoS header <-> frame ----------------------------------------------------

def _pack_str(s: Optional[str]) -> bytes:
    b = ("" if s is None else str(s)).encode()[:1024]
    return _STR_LEN.pack(len(b)) + b


def encode_qos_header(deadline: Optional[float] = None,
                      priority: Optional[str] = None,
                      tenant: Optional[str] = None,
                      trace=None, sid: Optional[str] = None,
                      resume_from: int = 0) -> bytes:
    """The complete QoS envelope as one flat header (module
    docstring).  `trace` is the `(trace_id, span_id)` pair the HTTP
    surface carries as X-Trace-Id / X-Parent-Span."""
    trace_id, parent = (trace if trace else (None, 0))
    fixed = _QOS_HDR.pack(
        qos.deadline_to_ms(deadline),
        qos.priority_to_code(priority),
        int(resume_from) & 0xFFFFFFFF,
        int(parent or 0) & 0xFFFFFFFFFFFFFFFF)
    return b"".join((fixed, _pack_str(tenant), _pack_str(trace_id),
                     _pack_str(sid)))


def decode_qos_header(buf: bytes) -> Dict[str, Any]:
    """Inverse of encode_qos_header, re-anchoring the deadline onto
    THIS process's clock (qos.deadline_from_ms).  Raises WireError on
    truncation or a skewed priority code."""
    try:
        dl_ms, prio, resume_from, parent = _QOS_HDR.unpack_from(buf, 0)
        off = _QOS_HDR.size
        strs = []
        for _ in range(3):
            (n,) = _STR_LEN.unpack_from(buf, off)
            off += _STR_LEN.size
            if off + n > len(buf):
                raise ValueError("truncated string field")
            strs.append(buf[off:off + n].decode() if n else None)
            off += n
        tenant, trace_id, sid = strs
        return {"deadline": qos.deadline_from_ms(dl_ms),
                "priority": qos.priority_from_code(prio),
                "tenant": qos.check_tenant(tenant),
                "trace": ((trace_id, int(parent)) if trace_id
                          else None),
                "sid": sid,
                "resume_from": int(resume_from)}
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise WireError(f"malformed QoS header: {e}") from e


# -- payload codecs ----------------------------------------------------------

def encode_request(op: int, tokens=None,
                   timeout: Optional[float] = None,
                   max_new: Optional[int] = None,
                   step: Optional[int] = None) -> bytes:
    if tokens is None:
        arr = np.empty(0, np.int32)
    else:
        arr = np.ascontiguousarray(tokens, dtype=np.int32)
    fixed = _REQ_HDR.pack(
        op,
        -1 if timeout is None else max(int(timeout * 1000), 0),
        -1 if max_new is None else int(max_new),
        _I32_NONE if step is None else int(step),
        arr.size)
    return fixed + arr.tobytes()


def decode_request(buf: bytes) -> Dict[str, Any]:
    try:
        op, t_ms, max_new, step, n = _REQ_HDR.unpack_from(buf, 0)
        if op not in _OP_NAMES:
            raise ValueError(f"unknown op {op}")
        need = _REQ_HDR.size + 4 * n
        if len(buf) < need:
            raise ValueError(f"token array truncated: want {need} "
                             f"bytes, have {len(buf)}")
        toks = np.frombuffer(buf, np.int32, count=n,
                             offset=_REQ_HDR.size)
        return {"op": op, "mode": _OP_NAMES[op],
                "timeout": None if t_ms < 0 else t_ms / 1000.0,
                "max_new": None if max_new < 0 else int(max_new),
                "step": None if step == _I32_NONE else int(step),
                "tokens": toks}
    except (struct.error, ValueError) as e:
        raise WireError(f"malformed request payload: {e}") from e


def token_frame_parts(first_i: int, view) -> List[Any]:
    """TOKENS payload as gather-write parts: the flat header plus the
    int32 token view itself — the ring's memory goes straight to the
    socket, zero intermediate copies."""
    arr = np.ascontiguousarray(view, dtype=np.int32)
    return [_TOK_HDR.pack(int(first_i) & 0xFFFFFFFF, arr.size),
            memoryview(arr).cast("B")]


def decode_tokens(buf: bytes) -> Tuple[int, np.ndarray]:
    try:
        first_i, n = _TOK_HDR.unpack_from(buf, 0)
        need = _TOK_HDR.size + 4 * n
        if len(buf) < need:
            raise ValueError(f"token batch truncated: want {need} "
                             f"bytes, have {len(buf)}")
        return int(first_i), np.frombuffer(buf, np.int32, count=n,
                                           offset=_TOK_HDR.size)
    except (struct.error, ValueError) as e:
        raise WireError(f"malformed token batch: {e}") from e


def encode_error(code: int, message: str,
                 retry_after: float = 0.0) -> bytes:
    return _ERR_HDR.pack(code,
                         max(int(retry_after * 1000), 0) & 0xFFFFFFFF
                         ) + str(message).encode()[:4096]


def decode_error(buf: bytes) -> Tuple[int, float, str]:
    try:
        code, ra_ms = _ERR_HDR.unpack_from(buf, 0)
        msg = buf[_ERR_HDR.size:].decode(errors="replace")
        return int(code), ra_ms / 1000.0, msg
    except struct.error as e:
        raise WireError(f"malformed error payload: {e}") from e


def error_for_exception(e: BaseException) -> Tuple[int, float, str]:
    """Server-side mapping: exception -> (code, retry_after, msg) —
    the frame twin of the HTTP handler's status mapping."""
    if isinstance(e, Overloaded):
        return E_OVERLOADED, float(getattr(e, "retry_after", 0.0)), \
            str(e)
    if isinstance(e, (DeadlineExpired, TimeoutError)):
        return E_DEADLINE, 0.0, str(e)
    if isinstance(e, Cancelled):
        return E_CANCELLED, 0.0, str(e)
    if isinstance(e, (ValueError, KeyError)):
        return E_BADREQ, 0.0, str(e)
    return E_INTERNAL, 0.0, f"{type(e).__name__}: {e}"


def exception_for_error(code: int, retry_after: float, msg: str,
                        engine: str) -> BaseException:
    """Client-side inverse: the Router's exception vocabulary."""
    if code == E_OVERLOADED:
        return Overloaded(msg, retry_after=retry_after)
    if code == E_DEADLINE:
        return DeadlineExpired(msg)
    if code == E_BADREQ:
        return ValueError(msg)
    if code == E_CANCELLED:
        return Cancelled(msg)
    return EngineUnavailable(f"engine {engine}: {msg}")


# -- frame send / receive ----------------------------------------------------

def frame_parts(kind: int, req_id: int, header: bytes = b"",
                payload_parts=()) -> List[Any]:
    plen = sum(len(p) for p in payload_parts)
    if len(header) > MAX_HEADER_LEN or plen > MAX_PAYLOAD_LEN:
        raise WireError(f"frame too large: header {len(header)}, "
                        f"payload {plen}")
    parts = [_PREAMBLE.pack(MAGIC, VERSION, kind, 0, 0,
                            int(req_id) & 0xFFFFFFFF,
                            len(header), plen)]
    if header:
        parts.append(header)
    parts.extend(payload_parts)
    return parts


def send_frame(sock, wlock: threading.Lock, kind: int, req_id: int,
               header: bytes = b"", payload_parts=(),
               stats: Optional[WireStats] = None) -> None:
    """Encode + gather-write one frame (socket.sendmsg: the token
    ring's memoryview reaches the kernel without an intermediate
    join).  Consults the `wire.frame` fault site: "error" drops the
    frame and fails the connection, "corrupt" flips the magic so the
    receiver counts it malformed, "torn" writes half the frame then
    fails the sender.  Raises ConnectionError/OSError on any send
    failure — the caller owns closing the connection."""
    st = stats or STATS
    t0 = time.perf_counter_ns()
    parts = frame_parts(kind, req_id, header, payload_parts)
    nbytes = sum(len(p) for p in parts)
    torn = False
    try:
        kind_f = faults.maybe_fault("wire.frame")
        if kind_f == "torn":
            torn = True
    except faults.CorruptRecord:
        st.count("faulted_frames")
        parts[0] = b"XX" + bytes(parts[0][2:])
    except faults.FaultError as e:
        st.count("faulted_frames")
        raise ConnectionError(f"injected wire.frame drop: {e}") from e
    st.count("ser_ns", time.perf_counter_ns() - t0)
    with wlock:
        if torn:
            st.count("faulted_frames")
            buf = b"".join(bytes(p) for p in parts)
            sock.sendall(buf[:max(len(buf) // 2, 1)])
            raise ConnectionError("injected wire.frame tear")
        try:
            sock.sendmsg(parts)
        except (AttributeError, NotImplementedError):
            sock.sendall(b"".join(bytes(p) for p in parts))
    st.count("frames_tx")
    st.count("bytes_tx", nbytes)


class FrameReader:
    """Buffered frame decoder over one socket.  `read_frame()` returns
    (kind, flags, req_id, header, payload), None on a clean EOF at a
    frame boundary, and raises WireError — counted
    `wire_malformed_total` — on anything else."""

    def __init__(self, sock, stats: Optional[WireStats] = None):
        self._f = sock.makefile("rb")
        self.stats = stats or STATS

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def _malformed(self, why: str) -> WireError:
        self.stats.count("malformed")
        return WireError(why)

    def read_frame(self):
        pre = self._f.read(_PREAMBLE.size)
        if not pre:
            return None                      # clean EOF
        if len(pre) < _PREAMBLE.size:
            raise self._malformed(
                f"truncated preamble ({len(pre)} bytes)")
        t0 = time.perf_counter_ns()
        magic, ver, kind, flags, _rsv, req_id, hlen, plen = \
            _PREAMBLE.unpack(pre)
        if magic != MAGIC:
            raise self._malformed(f"bad magic {magic!r}")
        if ver != VERSION:
            raise self._malformed(
                f"version skew: peer speaks v{ver}, this process "
                f"v{VERSION}")
        if kind not in KIND_NAMES:
            raise self._malformed(f"unknown frame kind {kind}")
        if hlen > MAX_HEADER_LEN or plen > MAX_PAYLOAD_LEN:
            raise self._malformed(
                f"oversized length prefix (header {hlen}, payload "
                f"{plen})")
        header = self._f.read(hlen) if hlen else b""
        payload = self._f.read(plen) if plen else b""
        if len(header) < hlen or len(payload) < plen:
            raise self._malformed("frame truncated mid-body")
        self.stats.count("frames_rx")
        self.stats.count("bytes_rx", _PREAMBLE.size + hlen + plen)
        self.stats.count("deser_ns", time.perf_counter_ns() - t0)
        return kind, flags, req_id, header, payload


# -- token ring --------------------------------------------------------------

class TokenRing:
    """Bounded shared-memory token channel for the in-process hop: a
    preallocated int32 buffer with absolute head/tail cursors under
    one Condition.  The producer appends raw token ids (no per-token
    object), the consumer peeks CONTIGUOUS batches as zero-copy numpy
    views — one lock round-trip per batch — and `consume()`s them
    once delivered, which is what keeps the view safe: space is only
    reusable after the consumer is done with it.  `finish`/`fail`
    carry the stream terminal through the same channel."""

    def __init__(self, capacity: int = 512):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf = np.empty(int(capacity), np.int32)
        self._cap = int(capacity)
        self._head = 0                       # absolute: next unread
        self._tail = 0                       # absolute: next write
        self._cv = threading.Condition()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None
        self._closed = False

    def __len__(self) -> int:
        with self._cv:
            return self._tail - self._head

    def push_many(self, tokens, timeout: Optional[float] = None
                  ) -> None:
        """Append token ids, blocking while the ring is full (the
        consumer owes a consume()).  Raises RuntimeError on a closed
        ring and TimeoutError when the consumer never drains."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        off = 0
        with self._cv:
            while off < toks.size:
                if self._closed:
                    raise RuntimeError("push to a closed TokenRing")
                free = self._cap - (self._tail - self._head)
                if free == 0:
                    if not self._cv.wait(timeout):
                        raise TimeoutError(
                            "TokenRing full: consumer stalled")
                    continue
                n = min(free, toks.size - off)
                pos = self._tail % self._cap
                run = min(n, self._cap - pos)
                self._buf[pos:pos + run] = toks[off:off + run]
                if n > run:
                    self._buf[0:n - run] = toks[off + run:off + n]
                self._tail += n
                off += n
                self._cv.notify_all()

    def finish(self, result: Dict[str, Any]) -> None:
        with self._cv:
            self._result = result
            self._closed = True
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            self._error = exc
            self._closed = True
            self._cv.notify_all()

    def peek_batch(self, max_n: int = 64,
                   timeout: Optional[float] = None):
        """Next contiguous unread run as ("toks", first_abs_index,
        int32 view) — zero-copy; call `consume(len(view))` when
        delivered.  ("done", result) after the producer finished and
        everything is drained.  Raises the producer's failure, or
        TimeoutError when nothing arrives in time."""
        with self._cv:
            while self._tail == self._head:
                if self._closed:
                    if self._error is not None:
                        raise self._error
                    return ("done", self._result)
                if not self._cv.wait(timeout):
                    raise TimeoutError("TokenRing stalled")
            n = min(int(max_n), self._tail - self._head)
            pos = self._head % self._cap
            n = min(n, self._cap - pos)      # contiguous run only
            return ("toks", self._head, self._buf[pos:pos + n])

    def consume(self, n: int) -> None:
        with self._cv:
            self._head = min(self._head + int(n), self._tail)
            self._cv.notify_all()


# -- ndjson flush batching ---------------------------------------------------

class LineCoalescer:
    """Batch serialized ndjson lines into one chunked write under the
    flush_tokens/flush_ms knobs.  The FIRST line of a stream (and any
    urgent line: terminals, errors) flushes immediately — batching
    must never tax first-token latency, which is a gated stage."""

    def __init__(self, write_fn, flush_tokens: int = 8,
                 flush_ms: float = 4.0,
                 stats: Optional[WireStats] = None):
        self._write = write_fn
        self.flush_tokens = max(int(flush_tokens), 1)
        self.flush_s = max(float(flush_ms), 0.0) / 1000.0
        self._buf: List[bytes] = []
        self._opened = 0.0
        self._first = True
        self._stats = stats or STATS

    def add(self, line: bytes, urgent: bool = False) -> None:
        if not self._buf:
            self._opened = time.monotonic()
        self._buf.append(line)
        if urgent or self._first or \
                len(self._buf) >= self.flush_tokens or \
                time.monotonic() - self._opened >= self.flush_s:
            self._first = False
            self.flush()

    def flush(self) -> None:
        if self._buf:
            data = b"".join(self._buf)
            self._buf = []
            self._stats.count("token_flushes")
            self._write(data)


# -- binary transport server -------------------------------------------------

class BinaryTransportServer:
    """The framed listener beside an `InferenceServer`'s HTTP
    frontend: long-lived connections, multiplexed in-flight requests
    (one worker thread per REQ, demuxed by req_id), batched TOKENS
    flushes straight off a TokenRing.  A malformed frame closes the
    connection (counted); everything else on that socket keeps its
    own req_id lane."""

    def __init__(self, server, host: str = "127.0.0.1",
                 port: int = 0,
                 flush_tokens: Optional[int] = None,
                 flush_ms: Optional[float] = None,
                 stats: Optional[WireStats] = None, log_fn=print):
        self.server = server
        self.stats = stats or STATS
        self.log = log_fn
        spec = server.engine.spec
        self.flush_tokens = int(flush_tokens
                                if flush_tokens is not None
                                else getattr(spec, "flush_tokens", 8))
        self.flush_ms = float(flush_ms if flush_ms is not None
                              else getattr(spec, "flush_ms", 4.0))
        self._host, self._port = host, int(port)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()

    @property
    def address(self):
        return self._sock.getsockname() if self._sock else None

    def start(self) -> "BinaryTransportServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._sock = s
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="wire-accept", daemon=True)
        self._accept_thread.start()
        self.log(f"serve: wire on {self.address[0]}:"
                 f"{self.address[1]}")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            # shutdown() the LISTENING socket first: close() alone
            # does not unblock a thread parked in accept() (the
            # in-flight syscall pins the file description, so the
            # port would keep accepting), shutdown() does
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # shutdown() unblocks the conn_loop thread parked in recv;
            # it then closes its own reader and drops the conn
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock = self._sock
                if sock is None:
                    return
                conn, _addr = sock.accept()
            except OSError:
                return                       # listener closed
            if self._stop.is_set():          # raced stop(): refuse
                try:
                    conn.close()
                except OSError:
                    pass
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            self.stats.count("conns_opened")
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="wire-conn", daemon=True).start()

    def _drop_conn(self, conn) -> None:
        with self._lock:
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass
        self.stats.count("conns_closed")

    def _conn_loop(self, conn) -> None:
        """One connection's demux loop: HELLO handshake, then every
        REQ gets its own worker thread writing replies through the
        shared write lock.  Any malformed frame — or any transport
        error — ends the WHOLE connection; in-flight workers notice
        on their next write and give up."""
        reader = FrameReader(conn, stats=self.stats)
        wlock = threading.Lock()
        cancels: Dict[int, threading.Event] = {}
        try:
            first = reader.read_frame()
            if first is None:
                return
            if first[0] != K_HELLO:
                raise reader._malformed(
                    f"expected HELLO, got {KIND_NAMES.get(first[0])}")
            send_frame(conn, wlock, K_HELLO, 0, stats=self.stats)
            while True:
                frame = reader.read_frame()
                if frame is None:
                    return
                kind, _flags, req_id, header, payload = frame
                if kind == K_CANCEL:
                    ev = cancels.get(req_id)
                    if ev is not None:
                        ev.set()
                    continue
                if kind != K_REQ:
                    continue                 # ignorable (future kinds
                                             # share the version)
                cancel = threading.Event()
                cancels[req_id] = cancel
                threading.Thread(
                    target=self._serve_req,
                    args=(conn, wlock, req_id, header, payload,
                          cancel, cancels),
                    name=f"wire-req-{req_id}", daemon=True).start()
        except WireError as e:
            obs.emit_event("wire.malformed", why=str(e))
            self.log(f"warning: wire connection closed on malformed "
                     f"frame: {e}")
        except (ConnectionError, OSError):
            pass                             # peer went away
        finally:
            for ev in cancels.values():
                ev.set()                     # orphaned workers stop
            reader.close()
            self._drop_conn(conn)

    def _send_err(self, conn, wlock, req_id,
                  e: BaseException) -> None:
        code, retry_after, msg = error_for_exception(e)
        try:
            send_frame(conn, wlock, K_ERR, req_id,
                       payload_parts=[encode_error(code, msg,
                                                   retry_after)],
                       stats=self.stats)
        except (ConnectionError, OSError):
            pass                             # conn already dead

    def _serve_req(self, conn, wlock, req_id, header, payload,
                   cancel, cancels) -> None:
        srv = self.server
        try:
            try:
                q = decode_qos_header(header) if header else {
                    "deadline": None, "priority": None,
                    "tenant": "default", "trace": None, "sid": None,
                    "resume_from": 0}
                req = decode_request(payload)
            except WireError as e:
                # the frame ITSELF parsed (length/magic fine) but the
                # body is skewed: an honest per-request error, the
                # connection survives
                self._send_err(conn, wlock, req_id, ValueError(str(e)))
                return
            tr = q["trace"][0] if q["trace"] else None
            psid = q["trace"][1] if q["trace"] else None
            op = req["op"]
            priority = qos.check_priority(q["priority"])
            if op == OP_PROBE:
                h = dict(srv.engine.health())
                h["queue_depth"] = srv.engine.stats.queue_depth
                self._reply_json(conn, wlock, req_id, h)
                return
            if op == OP_STATS:
                self._reply_json(conn, wlock, req_id, srv.snapshot())
                return
            if op == OP_RELOAD:
                with obs.span("serve.reload", trace=tr, parent=psid,
                              step=req["step"]):
                    outcome = srv.engine.reload_to(req["step"])
                self._reply_json(conn, wlock, req_id,
                                 {"outcome": outcome,
                                  "step": srv.engine.params_step})
                return
            with obs.span("serve.request", trace=tr, parent=psid,
                          mode=req["mode"], priority=priority,
                          tenant=q["tenant"], transport="wire"):
                if op == OP_STREAM:
                    self._serve_stream(conn, wlock, req_id, q, req,
                                       priority, cancel)
                    return
                call = (srv.generate if op == OP_GENERATE
                        else srv.predict)
                out = call(req["tokens"], timeout=req["timeout"],
                           deadline=q["deadline"], priority=priority,
                           tenant=q["tenant"], cancel_event=cancel,
                           **({"max_new": req["max_new"]}
                              if op == OP_GENERATE else {}))
            self._reply_json(conn, wlock, req_id, out)
        except (ConnectionError, OSError):
            pass                             # conn died under us
        except BaseException as e:  # noqa: BLE001 — mapped reply
            self._send_err(conn, wlock, req_id, e)
        finally:
            cancels.pop(req_id, None)

    def _reply_json(self, conn, wlock, req_id, obj,
                    kind: int = K_RESULT) -> None:
        send_frame(conn, wlock, kind, req_id,
                   payload_parts=[timed_json_dumps(obj,
                                                   self.stats)],
                   stats=self.stats)

    def _serve_stream(self, conn, wlock, req_id, q, req, priority,
                      cancel) -> None:
        """Admission, then batched TOKENS flushes off a TokenRing:
        the ring's int32 views gather-write straight into the socket
        (`token_frame_parts`).  The first token flushes alone; later
        batches linger up to flush_ms for up to flush_tokens."""
        srv = self.server
        t0 = time.monotonic()
        ticket = srv.generate_stream(
            req["tokens"], timeout=req["timeout"],
            max_new=req["max_new"], deadline=q["deadline"],
            priority=priority, tenant=q["tenant"],
            cancel_event=cancel, resume_from=q["resume_from"])
        budget = srv._wait_budget(req["timeout"], q["deadline"])
        ring = TokenRing(max(self.flush_tokens * 8, 64))
        i = ticket.first_index
        first = True
        linger = self.flush_ms / 1000.0
        while True:
            evs = ticket.drain_events(
                max_n=1 if first else self.flush_tokens,
                timeout=budget, linger_s=0.0 if first else linger)
            first = False
            toks = [p for k, p in evs if k == "tok"]
            tail = evs[-1] if evs[-1][0] != "tok" else None
            if toks:
                ring.push_many(toks)
                left = len(toks)
                while left > 0:
                    _kind, start, view = ring.peek_batch(left)
                    send_frame(
                        conn, wlock, K_TOKENS, req_id,
                        payload_parts=token_frame_parts(
                            i, view),
                        stats=self.stats)
                    n = len(view)
                    ring.consume(n)
                    i += n
                    left -= n
                self.stats.count("tokens_tx", len(toks))
                self.stats.count("token_flushes")
            if tail is None:
                continue
            if tail[0] == "failed":
                raise tail[1]
            out = dict(tail[1])
            out["done"] = True
            out["latency_ms"] = round((time.monotonic() - t0) * 1e3,
                                      3)
            self._reply_json(conn, wlock, req_id, out, kind=K_DONE)
            return


# -- binary client -----------------------------------------------------------

class _BinConn:
    """One persistent framed connection: socket + demux reader thread.
    Frames are routed to per-request queues by req_id; a transport
    death fails every in-flight lane with the SAME exception so each
    caller can map it for its own phase (admission vs mid-stream)."""

    def __init__(self, address, connect_timeout_s: float,
                 stats: WireStats):
        self.stats = stats
        self.sock = socket.create_connection(
            address, timeout=connect_timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                             1)
        self.sock.settimeout(None)
        self.wlock = threading.Lock()
        self._reader = FrameReader(self.sock, stats=stats)
        self._lanes: Dict[int, "queue.Queue"] = {}
        self._lanes_lock = threading.Lock()
        self._ids = _it_count(1)
        self.alive = True
        stats.count("conns_opened")
        # handshake synchronously, under the connect timeout: a peer
        # that is not a wire server must fail HERE, not on first use
        self.sock.settimeout(connect_timeout_s)
        try:
            send_frame(self.sock, self.wlock, K_HELLO, 0, stats=stats)
            got = self._reader.read_frame()
            if got is None or got[0] != K_HELLO:
                raise WireUnavailable(
                    "handshake failed: no HELLO from peer")
        except WireError as e:
            self._reader.close()
            self.sock.close()
            raise WireUnavailable(f"handshake failed: {e}") from e
        except Exception:
            self._reader.close()
            self.sock.close()
            raise
        self.sock.settimeout(None)
        self._thread = threading.Thread(target=self._demux,
                                        name="wire-demux",
                                        daemon=True)
        self._thread.start()

    def open_lane(self) -> Tuple[int, "queue.Queue"]:
        req_id = next(self._ids) & 0xFFFFFFFF
        q: "queue.Queue" = queue.Queue()
        with self._lanes_lock:
            if not self.alive:
                raise WireUnavailable("connection already dead")
            self._lanes[req_id] = q
        return req_id, q

    def close_lane(self, req_id: int) -> None:
        with self._lanes_lock:
            self._lanes.pop(req_id, None)

    def send(self, kind: int, req_id: int, header: bytes = b"",
             payload_parts=()) -> None:
        try:
            send_frame(self.sock, self.wlock, kind, req_id, header,
                       payload_parts, stats=self.stats)
        except (ConnectionError, OSError) as e:
            self.close(e)
            raise

    def _demux(self) -> None:
        err: BaseException = WireUnavailable("connection closed")
        try:
            while True:
                frame = self._reader.read_frame()
                if frame is None:
                    break
                kind, _flags, req_id, header, payload = frame
                with self._lanes_lock:
                    lane = self._lanes.get(req_id)
                if lane is not None:
                    lane.put(("frame", kind, header, payload))
        except WireError as e:
            err = WireUnavailable(f"malformed reply frame: {e}")
        except (ConnectionError, OSError) as e:
            err = WireUnavailable(f"connection lost: {e}")
        finally:
            self.close(err)
            # the demux thread OWNS the buffered reader: closing it
            # from any other thread would block on the buffer lock we
            # hold while parked in recv
            self._reader.close()

    def close(self, err: Optional[BaseException] = None) -> None:
        with self._lanes_lock:
            if not self.alive:
                return
            self.alive = False
            lanes = list(self._lanes.values())
            self._lanes.clear()
        e = err if err is not None else \
            WireUnavailable("connection closed")
        for lane in lanes:
            lane.put(("conn_err", e))
        # shutdown() first: it unblocks a demux thread parked in recv
        # (close() alone would not, and the fd lingers behind the
        # reader's io-ref anyway)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.stats.count("conns_closed")


class BinaryEngineHandle:
    """Worker behind a framed socket: the binary twin of
    `HttpEngineHandle`, same duck-typed surface (`probe`,
    `stats_snapshot`, `request`, `request_stream`, `reload`) and the
    same exception vocabulary, so Router dispatch, hedge legs,
    failover resumes, and WAL'd session replay ride it unchanged.
    ONE long-lived connection multiplexes every in-flight request;
    a dead connection is rebuilt on the next call (counted
    `wire_reconnects_total`)."""

    def __init__(self, name: str, address,
                 connect_timeout_s: float = 5.0,
                 stats: Optional[WireStats] = None):
        self.name = name
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = (address[0], int(address[1]))
        self.connect_timeout_s = float(connect_timeout_s)
        self.stats = stats or STATS
        self._conn: Optional[_BinConn] = None
        self._conn_lock = threading.Lock()

    # -- connection management ----------------------------------------------
    def _connect(self) -> Tuple[_BinConn, bool]:
        """(connection, was_reused).  Raises WireUnavailable when the
        peer is unreachable or does not speak the protocol."""
        with self._conn_lock:
            if self._conn is not None and self._conn.alive:
                return self._conn, True
            if self._conn is not None:
                self.stats.count("reconnects")
            try:
                self._conn = _BinConn(self.address,
                                      self.connect_timeout_s,
                                      self.stats)
            except (ConnectionError, OSError, TimeoutError) as e:
                self._conn = None
                raise WireUnavailable(
                    f"engine {self.name} unreachable at "
                    f"{self.address[0]}:{self.address[1]}: {e}"
                ) from e
            return self._conn, False

    def close(self) -> None:
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _open(self, op: int, header: bytes, tokens=None,
              timeout=None, max_new=None, step=None):
        """Send one REQ, retrying ONCE on a stale reused connection
        (the keep-alive race: the peer closed an idle socket between
        our calls — nothing was processed, resending is safe)."""
        for attempt in (0, 1):
            conn, reused = self._connect()
            req_id, lane = conn.open_lane()
            try:
                conn.send(K_REQ, req_id, header,
                          [encode_request(op, tokens, timeout,
                                          max_new, step)])
                return conn, req_id, lane
            except (ConnectionError, OSError) as e:
                conn.close_lane(req_id)
                if not reused or attempt == 1:
                    raise WireUnavailable(
                        f"engine {self.name} send failed: {e}"
                    ) from e
        raise WireUnavailable(f"engine {self.name} send failed")

    def _wait(self, conn, req_id: int, lane, budget: float):
        """One reply frame for req_id, or the mapped failure.  A
        transport death or a silence past `budget` is
        WireUnavailable — the engine may be fine, the WIRE is not."""
        try:
            got = lane.get(timeout=max(budget, 0.1))
        except queue.Empty:
            conn.close_lane(req_id)
            raise WireUnavailable(
                f"engine {self.name}: no reply within "
                f"{budget:.1f}s") from None
        if got[0] == "conn_err":
            raise got[1]
        return got[1], got[2], got[3]        # kind, header, payload

    def _unary(self, op: int, header: bytes, budget: float,
               tokens=None, timeout=None, max_new=None, step=None
               ) -> Dict[str, Any]:
        try:
            conn, req_id, lane = self._open(op, header, tokens,
                                            timeout, max_new, step)
        except WireUnavailable as e:
            raise EngineUnavailable(str(e)) from e
        try:
            try:
                kind, _h, payload = self._wait(conn, req_id, lane,
                                               budget)
            except WireUnavailable as e:
                raise EngineUnavailable(str(e)) from e
            if kind == K_ERR:
                raise exception_for_error(*decode_error(payload),
                                          engine=self.name)
            if kind != K_RESULT:
                raise EngineUnavailable(
                    f"engine {self.name}: unexpected "
                    f"{KIND_NAMES.get(kind)} reply")
            return timed_json_loads(payload, self.stats)
        finally:
            conn.close_lane(req_id)

    # -- the engine-handle surface ------------------------------------------
    def probe(self) -> Dict[str, Any]:
        return self._unary(OP_PROBE, b"", self.connect_timeout_s)

    def stats_snapshot(self) -> Dict[str, Any]:
        return self._unary(OP_STATS, b"", self.connect_timeout_s)

    def reload(self, step: Optional[int] = None,
               trace=None) -> Dict[str, Any]:
        return self._unary(
            OP_RELOAD, encode_qos_header(trace=trace), 60.0,
            step=-1 if step is None else step)

    def request(self, mode: str, tokens,
                timeout: Optional[float] = None,
                deadline: Optional[float] = None,
                priority: Optional[str] = None,
                trace=None,
                tenant: Optional[str] = None) -> Dict[str, Any]:
        header = encode_qos_header(deadline=deadline,
                                   priority=priority, tenant=tenant,
                                   trace=trace)
        budget = qos.transport_budget(deadline, timeout,
                                      self.connect_timeout_s)
        op = OP_GENERATE if mode == "generate" else OP_PREDICT
        return self._unary(op, header, budget, tokens=tokens,
                           timeout=timeout)

    def request_stream(self, tokens, timeout: Optional[float] = None,
                       max_new: Optional[int] = None,
                       deadline: Optional[float] = None,
                       priority: Optional[str] = None,
                       resume_from: int = 0, trace=None,
                       tenant: Optional[str] = None):
        """Streaming generate over the framed connection.  Admission
        errors surface on the FIRST next() as mapped exceptions (the
        router's retry-on-other-engine commit point); after the first
        token a transport failure is a mid-stream RuntimeError the
        session layer catches and RESUMES on a sibling.  Closing the
        generator (hedge loser, abandoned failover leg) sends CANCEL
        and frees the lane — the CONNECTION survives for its other
        in-flight requests."""
        header = encode_qos_header(deadline=deadline,
                                   priority=priority, tenant=tenant,
                                   trace=trace,
                                   resume_from=resume_from)
        budget = qos.transport_budget(deadline, timeout,
                                      self.connect_timeout_s)

        def gen():
            try:
                conn, req_id, lane = self._open(
                    OP_STREAM, header, tokens=tokens,
                    timeout=timeout, max_new=max_new)
            except WireUnavailable as e:
                raise EngineUnavailable(str(e)) from e
            streamed = False
            finished = False
            try:
                while True:
                    try:
                        got = lane.get(timeout=max(budget, 0.1))
                    except queue.Empty:
                        raise TimeoutError(
                            f"engine {self.name} stream stalled"
                        ) from None
                    if got[0] == "conn_err":
                        if streamed:
                            e = RuntimeError(
                                f"engine {self.name} stream broken: "
                                f"{got[1]}")
                            e.wire_transport = True
                            raise e
                        raise EngineUnavailable(
                            f"engine {self.name}: {got[1]}")
                    kind, _h, payload = got[1], got[2], got[3]
                    if kind == K_TOKENS:
                        first_i, toks = decode_tokens(payload)
                        streamed = True
                        i = first_i
                        for t in toks:
                            yield {"token": int(t), "i": i}
                            i += 1
                    elif kind == K_DONE:
                        finished = True
                        yield timed_json_loads(payload, self.stats)
                        return
                    elif kind == K_ERR:
                        exc = exception_for_error(
                            *decode_error(payload), engine=self.name)
                        if streamed:
                            raise RuntimeError(
                                f"engine {self.name} stream failed: "
                                f"{exc}")
                        raise exc
                    # other kinds: version-compatible noise, skip
            finally:
                conn.close_lane(req_id)
                if not finished and conn.alive:
                    try:
                        conn.send(K_CANCEL, req_id)
                        self.stats.count("cancels_tx")
                    except (ConnectionError, OSError):
                        pass
        return gen()


# -- transport negotiation ---------------------------------------------------

def register_into(registry, prefix: str = "singa_wire") -> None:
    """Export the process-wide wire counters into a MetricsRegistry
    (the perf.register_into mold)."""
    STATS.register_into(registry, prefix=prefix)
