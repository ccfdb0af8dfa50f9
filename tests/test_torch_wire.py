"""The port's binary wire (`singa_tpu_torch/serve/wire.py`) held against
the JAX package's (`singa_tpu/serve/wire.py`): the frame codec byte for
byte, decoded across the packages both ways; malformed input (every cut
point of a truncated frame, garbage magic, version skew, oversized
length prefixes, unknown kinds) counted and refused; `TokenRing` and
`LineCoalescer`; each package's `BinaryEngineHandle` driving the other's
`BinaryTransportServer`; and the gate of ROADMAP.md A5: a JAX `Router`
adopts a port `InferenceServer` through `HttpEngineHandle`, and through
`NegotiatingEngineHandle` over the wire, and generates and streams the
port's in-process tokens, which equal the JAX server's on the same
weights.  A tiny LM (2 layers, E=32, V=64, f32, cb=on).  Every socket
listens on port 0 and every wait has a timeout."""

import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

import singa_tpu.serve.wire as jwire
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.serve import InferenceEngine as JEngine
from singa_tpu.serve import InferenceServer as JServer
from singa_tpu.serve import ServeSpec as JSpec
from singa_tpu.serve.router import EngineUnavailable as JUnavailable
from singa_tpu.serve.router import HttpEngineHandle, Router, RouterSpec

import singa_tpu_torch.serve.wire as twire
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.serve import InferenceEngine, InferenceServer, ServeSpec
from singa_tpu_torch.serve.router import EngineUnavailable
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
PKGS = {"jax": jwire, "torch": twire}
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
QUIET = dict(log_fn=lambda s: None)
WAIT = 30.0


# -- the codec ----------------------------------------------------------------

def _frames(w):
    """Every frame kind, built with module `w`, as bytes."""
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 1 << 30, 17).astype(np.int32)
    cases = [
        (w.K_HELLO, b"", []),
        (w.K_REQ, w.encode_qos_header(priority="batch", tenant="acme",
                                      trace=("tr-77", 12345), sid="s3-9",
                                      resume_from=41),
         [w.encode_request(w.OP_STREAM, toks, timeout=2.5, max_new=9)]),
        (w.K_REQ, w.encode_qos_header(),
         [w.encode_request(w.OP_GENERATE, None)]),
        (w.K_REQ, w.encode_qos_header(priority="interactive"),
         [w.encode_request(w.OP_RELOAD, None, step=12)]),
        (w.K_RESULT, b"", [json.dumps({"tokens": [4, 5]}).encode()]),
        (w.K_TOKENS, b"", w.token_frame_parts(9, toks)),
        (w.K_DONE, b"", [json.dumps({"done": True}).encode()]),
        (w.K_ERR, b"", [w.encode_error(w.E_OVERLOADED, "busy", 0.5)]),
        (w.K_ERR, b"", [w.encode_error(w.E_DEADLINE, "too late é")]),
        (w.K_CANCEL, b"", []),
    ]
    return [b"".join(bytes(p) for p in w.frame_parts(kind, 42 + i, hdr,
                                                     parts))
            for i, (kind, hdr, parts) in enumerate(cases)]


def test_codec_is_byte_for_byte_the_jax_package_s():
    got, want = _frames(twire), _frames(jwire)
    assert got == want
    for name in ("MAGIC", "VERSION", "MAX_HEADER_LEN", "MAX_PAYLOAD_LEN",
                 "E_UNAVAILABLE", "E_OVERLOADED", "E_DEADLINE", "E_BADREQ",
                 "E_CANCELLED", "E_INTERNAL", "KIND_NAMES"):
        assert getattr(twire, name) == getattr(jwire, name), name


def _read(w, raw):
    """(frame or WireError, malformed count) of `raw` through module
    `w`'s FrameReader over a socketpair."""
    a, b = socket.socketpair()
    st = w.WireStats()
    try:
        a.sendall(raw)
        a.close()
        b.settimeout(5.0)              # a hang fails the test, fast
        try:
            out = w.FrameReader(b, stats=st).read_frame()
        except w.WireError as e:
            out = e
        return out, st.snapshot()["malformed"]
    finally:
        b.close()


@pytest.mark.parametrize("enc,dec", [(a, b) for a in PKGS for b in PKGS])
def test_frames_decode_across_packages(enc, dec):
    e, d = PKGS[enc], PKGS[dec]
    for raw in _frames(e):
        (kind, flags, req_id, hdr, payload), bad = _read(d, raw)
        assert bad == 0 and flags == 0
        if kind == d.K_REQ:
            got, want = d.decode_qos_header(hdr), jwire.decode_qos_header(hdr)
            assert got == want
            got, want = d.decode_request(payload), \
                jwire.decode_request(payload)
            np.testing.assert_array_equal(got.pop("tokens"),
                                          want.pop("tokens"))
            assert got == want
        elif kind == d.K_TOKENS:
            first, arr = d.decode_tokens(payload)
            jfirst, jarr = jwire.decode_tokens(payload)
            assert first == jfirst == 9
            np.testing.assert_array_equal(arr, jarr)
        elif kind == d.K_ERR:
            assert d.decode_error(payload) == jwire.decode_error(payload)
    # deadlines cross as remaining milliseconds
    deadline = time.monotonic() + 12.0
    got = d.decode_qos_header(e.encode_qos_header(deadline=deadline))
    assert abs(got["deadline"] - deadline) < 1.0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_malformed_frames_are_counted_and_refused(pkg):
    w = PKGS[pkg]
    pre = w._PREAMBLE
    cases = {
        "magic": b"XX" + b"\x00" * 14,
        "version": pre.pack(w.MAGIC, w.VERSION + 1, w.K_HELLO, 0, 0, 1,
                            0, 0),
        "payload": pre.pack(w.MAGIC, w.VERSION, w.K_REQ, 0, 0, 1, 0,
                            w.MAX_PAYLOAD_LEN + 1),
        "header": pre.pack(w.MAGIC, w.VERSION, w.K_REQ, 0, 0, 1,
                           w.MAX_HEADER_LEN + 1, 0),
        "kind": pre.pack(w.MAGIC, w.VERSION, 200, 0, 0, 1, 0, 0),
    }
    for why, raw in cases.items():
        out, bad = _read(w, raw)
        jout, jbad = _read(jwire, raw)
        assert isinstance(out, w.WireError) and bad == jbad == 1, why
        assert str(out) == str(jout), why
    clean, bad = _read(w, b"")
    assert clean is None and bad == 0
    whole = _frames(w)[1]
    for cut in range(1, len(whole)):
        out, bad = _read(w, whole[:cut])
        assert isinstance(out, w.WireError), f"cut at {cut}: {out!r}"
        assert bad == 1
    rng = np.random.default_rng(99)
    for _ in range(100):
        raw = rng.integers(0, 256, int(rng.integers(1, 64))).astype(np.uint8)
        out, _ = _read(w, raw.tobytes())
        assert out is None or isinstance(out, w.WireError)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_token_ring_cases(pkg):
    TokenRing = PKGS[pkg].TokenRing
    ring = TokenRing(capacity=8)
    out = []
    ring.push_many([1, 2, 3, 4, 5])
    kind, start, view = ring.peek_batch(64)
    assert kind == "toks" and start == 0
    out.extend(int(t) for t in view)
    ring.consume(len(view))
    ring.push_many([6, 7, 8, 9, 10, 11])       # wraps
    while len(ring):
        _k, _s, view = ring.peek_batch(64)
        out.extend(int(t) for t in view)
        ring.consume(len(view))
    assert out == list(range(1, 12))
    full = TokenRing(capacity=4)
    full.push_many([1, 2, 3, 4])
    with pytest.raises(TimeoutError):
        full.push_many([5], timeout=0.05)
    done = []

    def producer():
        full.push_many([5, 6], timeout=5.0)
        done.append(True)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    _k, _s, view = full.peek_batch(2)
    full.consume(len(view))
    t.join(5.0)
    assert done == [True] and not t.is_alive()
    term = TokenRing(capacity=4)
    term.push_many([7])
    term.finish({"finish": "eos"})
    k, _s, view = term.peek_batch(8)
    assert k == "toks" and list(view) == [7]
    term.consume(1)
    assert term.peek_batch(8) == ("done", {"finish": "eos"})
    with pytest.raises(RuntimeError):
        term.push_many([8])
    dead = TokenRing(capacity=4)
    dead.fail(RuntimeError("slot died"))
    with pytest.raises(RuntimeError, match="slot died"):
        dead.peek_batch(8)
    with pytest.raises(TimeoutError):
        TokenRing(capacity=4).peek_batch(8, timeout=0.05)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_line_coalescer_cases(pkg):
    w = PKGS[pkg]
    writes = []
    co = w.LineCoalescer(writes.append, flush_tokens=4, flush_ms=1e4,
                         stats=w.WireStats())
    co.add(b"a\n")
    assert writes == [b"a\n"]            # the first line flushes alone
    co.add(b"b\n")
    co.add(b"c\n")
    assert writes == [b"a\n"]
    co.add(b"d\n")
    co.add(b"e\n")
    assert writes == [b"a\n", b"b\nc\nd\ne\n"]
    co.add(b"f\n")
    co.add(b"g\n", urgent=True)
    assert writes[-1] == b"f\ng\n"
    lazy = w.LineCoalescer(writes.append, flush_tokens=8, flush_ms=0.0,
                           stats=w.WireStats())
    lazy.add(b"x\n")
    lazy.add(b"y\n")                     # flush_ms 0: no lingering
    assert writes[-1] == b"y\n"


def test_error_mapping_matches_jax():
    from singa_tpu.serve import batcher as jb
    from singa_tpu_torch.serve import batcher as tb
    for tmod, jmod in ((tb, jb),):
        for mk in (lambda m: m.Overloaded("busy", retry_after=0.25),
                   lambda m: m.DeadlineExpired("late"),
                   lambda m: m.Cancelled("gone"),
                   lambda m: ValueError("bad"), lambda m: KeyError("k"),
                   lambda m: TimeoutError("t"), lambda m: OSError("boom")):
            assert twire.error_for_exception(mk(tmod)) == \
                jwire.error_for_exception(mk(jmod))
    for code in range(1, 7):
        got = twire.exception_for_error(code, 0.5, "m", engine="e")
        want = jwire.exception_for_error(code, 0.5, "m", engine="e")
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
    assert isinstance(twire.exception_for_error(twire.E_INTERNAL, 0, "m",
                                                engine="e"),
                      EngineUnavailable)


# -- live servers: the port's and the JAX package's, same weights -------------

@pytest.fixture(scope="module")
def servers():
    tnet = tbuild_net(ttransformer_lm(**CFG), "kTest", SHAPES)
    jnet = jbuild_net(jtransformer_lm(**CFG), "kTest", SHAPES)
    arrays = numpy_params(tnet, seed=0)
    kw = dict(buckets=((2, SEQ),), max_new_tokens=8, batch_window_s=0.002,
              request_timeout_s=60.0, cb="on", cb_slots=3, cb_block_len=4)
    teng = InferenceEngine(tnet, ServeSpec(**kw),
                           params_from_numpy(tnet, arrays, device="cpu"),
                           device="cpu", **QUIET)
    jeng = JEngine(jnet, JSpec(**kw),
                   params={k: jnp.asarray(v) for k, v in arrays.items()},
                   **QUIET)
    tsrv = InferenceServer(teng, port=0, wire_on=True, **QUIET).start()
    jsrv = JServer(jeng, port=0, wire_on=True, **QUIET).start()
    prompt = np.arange(1, 5, dtype=np.int32)
    ref = tsrv.generate(prompt)["tokens"]
    assert ref == jsrv.generate(prompt)["tokens"] and len(ref) == 8
    yield tsrv, jsrv, prompt, ref
    tsrv.stop()
    jsrv.stop()


@pytest.mark.parametrize("handle_pkg,server_pkg",
                         [("jax", "torch"), ("torch", "jax"),
                          ("torch", "torch")])
def test_binary_handle_drives_the_other_package_s_server(
        servers, handle_pkg, server_pkg):
    tsrv, jsrv, prompt, ref = servers
    srv = tsrv if server_pkg == "torch" else jsrv
    h = PKGS[handle_pkg].BinaryEngineHandle("e0", srv.wire_address)
    try:
        assert h.probe()["ok"]
        assert h.request("generate", prompt, timeout=WAIT)["tokens"] == ref
        evs = list(h.request_stream(prompt, timeout=WAIT, max_new=8))
        assert [ev["token"] for ev in evs if "done" not in ev] == ref
        assert [ev["i"] for ev in evs if "done" not in ev] == list(range(8))
        assert evs[-1]["done"] and evs[-1]["finish"] == "length"
        lp = h.request("predict", prompt, timeout=WAIT)["logprobs"]
        assert len(lp) == VOCAB
        assert h.stats_snapshot()["completed"] >= 1
        with pytest.raises(ValueError):
            h.request("generate", np.arange(100, dtype=np.int32),
                      timeout=5)
    finally:
        h.close()
    unavailable = EngineUnavailable if handle_pkg == "torch" \
        else JUnavailable
    with socket.socket() as s:          # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()
    h = PKGS[handle_pkg].BinaryEngineHandle("e1", dead,
                                            connect_timeout_s=2.0)
    try:
        with pytest.raises(unavailable):
            h.probe()
    finally:
        h.close()


def test_malformed_bytes_close_a_live_port_connection(servers):
    tsrv, _, _, _ = servers
    before = twire.STATS.snapshot()["malformed"]
    s = socket.create_connection(tsrv.wire_address, timeout=5.0)
    s.sendall(b"GET / HTTP/1.1\r\n\r\n")       # not this protocol
    s.settimeout(5.0)
    assert s.recv(64) == b""                   # closed, not hung
    s.close()
    assert twire.STATS.snapshot()["malformed"] > before
    h = twire.BinaryEngineHandle("e0", tsrv.wire_address)
    try:
        assert h.probe()["ok"]
    finally:
        h.close()


@pytest.mark.parametrize("transport", ["http", "wire"])
def test_jax_router_adopts_a_port_server(servers, transport):
    """ROADMAP.md A5's gate."""
    tsrv, _, prompt, ref = servers
    host, port = tsrv.address
    url = f"http://{host}:{port}"
    handle = (HttpEngineHandle("torch-0", url) if transport == "http"
              else jwire.NegotiatingEngineHandle("torch-0", url, **QUIET))
    r = Router([handle], spec=RouterSpec(probe_period_s=60.0,
                                         request_timeout_s=WAIT,
                                         hedge="off"), **QUIET)
    try:
        r.probe_all()
        if transport == "wire":
            assert handle.transport == "binary"
        out = r.route("generate", prompt, timeout=WAIT)
        assert out["tokens"] == ref and out["engine"] == "torch-0"
        evs = list(r.route_stream(prompt, timeout=WAIT, max_new=8))
        assert [ev["token"] for ev in evs if "token" in ev] == ref
        assert evs[-1].get("done")
        lp = r.route("predict", prompt, timeout=WAIT)["logprobs"]
        assert len(lp) == VOCAB
        if transport == "wire":
            assert handle.transport == "binary"
    finally:
        r.stop()
        handle.close()
