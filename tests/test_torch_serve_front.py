"""The port's serving front ends (`singa_tpu_torch/serve/`: the
`MicroBatcher`, `InferenceServer` over HTTP, and the engine's checkpoint
load, hot reload and `health()`) through the scenarios of
`tests/test_serve.py`.  Where the JAX server can run the same case it
runs beside the port's on the same numpy weights, and the two must give
equal tokens, outcome strings, HTTP status codes and JSON keys.

A tiny LM (2 layers, E=32, 4 heads of 8, V=64, f32).  Tokens are held
exactly; predict's log-probs to rtol/atol 1e-5, as the port's logits.
Workspaces are written by both packages' `CheckpointManager` in npz (the
JAX one with `_HAVE_ORBAX` patched to False), with health verdicts.

A reload in the port copies into the live tensors the engine's graphs
were captured over (`InferenceEngine._swap`), so the reference's
"in-flight batch keeps the old params" case becomes: a reload waits
for the batch that holds the engine (`hold()`), and a refused geometry
leaves the live tensors bit-equal.  Every socket listens on port 0 and
every wait has a timeout."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import singa_tpu.serve.batcher as jbatcher
import singa_tpu.utils.checkpoint as jckpt
import singa_tpu.utils.faults as jfaults
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.serve import InferenceEngine as JEngine
from singa_tpu.serve import InferenceServer as JServer
from singa_tpu.serve import ServeSpec as JSpec
from singa_tpu.serve.stats import ServeStats as JStats

import singa_tpu_torch.serve.batcher as tbatcher
import singa_tpu_torch.utils.checkpoint as tckpt
import singa_tpu_torch.utils.faults as tfaults
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.models.generate import generate as tgenerate
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.obs import perf as tperf
from singa_tpu_torch.serve import (InferenceEngine, InferenceServer,
                                   ServeSpec, ServeStats)
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
RTOL = ATOL = 1e-5
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
QUIET = dict(log_fn=lambda s: None)
WAIT = 30.0
OPT = {"t": np.zeros((), np.float32)}


def _nets():
    jnet = jbuild_net(jtransformer_lm(**CFG), "kTest", SHAPES)
    tnet = tbuild_net(ttransformer_lm(**CFG), "kTest", SHAPES)
    return jnet, tnet


def _arrays(tnet, seed=0, scale=1.0):
    return {k: (v * scale).astype(np.float32)
            for k, v in numpy_params(tnet, seed=seed).items()}


def _tparams(tnet, arrays):
    return params_from_numpy(tnet, arrays, device="cpu")


def _jparams(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _url(server, path):
    host, port = server.address
    return f"http://{host}:{port}{path}"


def _post(server, path, body, raw=None):
    """(status, headers, json body) of one POST; HTTP errors included."""
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(_url(server, path), data=data)
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _until(cond, budget=WAIT):
    """Poll `cond` every 10 ms until it holds or `budget` seconds pass."""
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < budget:
        time.sleep(0.01)
    return cond()


def _get(server, path):
    try:
        with urllib.request.urlopen(_url(server, path), timeout=WAIT) as r:
            body = r.read()
            return r.status, body
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# -- the bucket path: one port server and one JAX server, same weights -------

@pytest.fixture(scope="module")
def pair():
    jnet, tnet = _nets()
    arrays = _arrays(tnet)
    kw = dict(buckets=((2, 6), (4, 12)), max_new_tokens=5,
              batch_window_s=0.01, request_timeout_s=20.0)
    teng = InferenceEngine(tnet, ServeSpec(**kw), _tparams(tnet, arrays),
                           device="cpu", **QUIET)
    jeng = JEngine(jnet, JSpec(**kw), params=_jparams(arrays), **QUIET)
    tsrv = InferenceServer(teng, port=0, **QUIET).start()
    jsrv = JServer(jeng, port=0, warmup_modes=("generate", "predict"),
                   **QUIET).start()
    yield tnet, arrays, tsrv, jsrv
    tsrv.stop()
    jsrv.stop()


def test_padded_bucket_matches_unpadded_generate(pair):
    tnet, arrays, tsrv, jsrv = pair
    rng = np.random.default_rng(0)
    for plen in (1, 4, 9, 12):
        prompt = rng.integers(1, VOCAB, plen).astype(np.int32)
        ref = tgenerate(tnet, tsrv.engine.params,
                        torch.from_numpy(prompt)[None], 5)[0].tolist()
        got = tsrv.generate(prompt)
        assert got["tokens"] == ref, f"plen={plen}"
        want = jsrv.generate(prompt)
        assert want["tokens"] == ref
        assert set(got) == set(want)
        assert got["bucket"] == want["bucket"]
        assert got["step"] == want["step"] == -1


def test_concurrent_mixed_lengths_zero_captures_after_warmup(pair):
    tnet, _, tsrv, _ = pair
    engine = tsrv.engine
    warm, anomalies = engine.stats.compiles, tperf.watch().anomalies
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, rng.integers(1, 13)).astype(
        np.int32) for _ in range(16)]
    outs, errs = {}, []

    def client(i, p):
        try:
            outs[i] = tsrv.generate(p)["tokens"]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(outs) == 16
    for i, p in enumerate(prompts):
        ref = tgenerate(tnet, engine.params, torch.from_numpy(p)[None], 5)
        assert outs[i] == ref[0].tolist()
    assert engine.stats.compiles == warm
    assert tperf.watch().anomalies == anomalies
    occ = engine.stats.occupancy()
    assert occ is not None and 0 < occ <= 1.0


def test_predict_logprobs_match_jax(pair):
    _, _, tsrv, jsrv = pair
    got = tsrv.predict(np.array([3, 1, 4], np.int32))
    want = jsrv.predict(np.array([3, 1, 4], np.int32))
    assert set(got) == set(want)
    lp = np.asarray(got["logprobs"])
    assert lp.shape == (VOCAB,)
    assert abs(float(np.exp(lp).sum()) - 1.0) < 1e-4
    np.testing.assert_allclose(lp, want["logprobs"], rtol=RTOL, atol=ATOL)


def test_http_roundtrip_matches_jax(pair):
    _, _, tsrv, jsrv = pair
    replies = {}
    for name, srv in (("torch", tsrv), ("jax", jsrv)):
        code, _, out = _post(srv, "/generate", {"tokens": [5, 9, 3]})
        assert code == 200
        code, stats = _get(srv, "/stats")
        assert code == 200
        code, health = _get(srv, "/healthz")
        assert code == 200
        code, metrics = _get(srv, "/metrics")
        assert code == 200
        code, trace = _get(srv, "/trace")
        assert code == 200
        replies[name] = (out, json.loads(stats), json.loads(health),
                         metrics.decode(), json.loads(trace))
    (tout, tstats, thealth, tmetrics, ttrace), \
        (jout, jstats, jhealth, _, jtrace) = replies["torch"], replies["jax"]
    assert tout["tokens"] == jout["tokens"] and len(tout["tokens"]) == 5
    assert set(tout) == set(jout)
    assert set(tstats) == set(jstats) and tstats["completed"] >= 1
    assert thealth == jhealth == {"ok": True, "status": "ok", "step": -1,
                                  "family": "default", "pinned": False,
                                  "reasons": []}
    assert ttrace == jtrace
    for name in ("singa_serve_completed_total", "singa_wire_",
                 "singa_process_threads", "singa_tenant_submitted_total",
                 "singa_serve_request_latency_seconds_bucket"):
        assert name in tmetrics, name


@pytest.mark.parametrize("case", ["long_prompt", "bad_json", "no_route",
                                  "admit_fault", "dead_on_arrival",
                                  "batch_fault", "bad_reload"])
def test_http_status_codes_match_jax(pair, case):
    _, _, tsrv, jsrv = pair
    got = {}
    for name, srv, faults in (("torch", tsrv, tfaults),
                              ("jax", jsrv, jfaults)):
        path, body, raw, sched = "/generate", {"tokens": [1, 2]}, None, None
        if case == "long_prompt":
            body = {"tokens": list(range(1, 14))}
        elif case == "bad_json":
            raw = b"{not json"
        elif case == "no_route":
            path = "/nope"
        elif case == "admit_fault":
            sched = "serve.admit@0:error"
        elif case == "dead_on_arrival":
            body = {"tokens": [1, 2], "timeout": 1e-9}
        elif case == "batch_fault":
            sched = "serve.batch@0:error"
        elif case == "bad_reload":
            path, body = "/admin/reload", {"step": "x"}
        with faults.inject(faults.FaultSchedule.parse(sched)
                           if sched else None):
            code, headers, out = _post(srv, path, body, raw)
        got[name] = (code, "Retry-After" in headers, sorted(out))
    assert got["torch"] == got["jax"]
    want = {"long_prompt": 400, "bad_json": 400, "no_route": 404,
            "admit_fault": 503, "dead_on_arrival": 504,
            "batch_fault": 500, "bad_reload": 400}[case]
    assert got["torch"][0] == want
    assert got["torch"][1] == (case == "admit_fault")
    # the servers stay up
    assert tsrv.generate([1, 2])["tokens"] == jsrv.generate([1, 2])["tokens"]


# -- continuous batching: ndjson streaming -----------------------------------

@pytest.fixture(scope="module")
def cb_pair():
    jnet, tnet = _nets()
    arrays = _arrays(tnet, seed=1)
    kw = dict(buckets=((2, SEQ),), max_new_tokens=8, cb="on", cb_slots=3,
              cb_block_len=4, request_timeout_s=20.0, flush_tokens=3)
    teng = InferenceEngine(tnet, ServeSpec(**kw), _tparams(tnet, arrays),
                           device="cpu", **QUIET)
    jeng = JEngine(jnet, JSpec(**kw), params=_jparams(arrays), **QUIET)
    tsrv = InferenceServer(teng, port=0, **QUIET).start()
    jsrv = JServer(jeng, port=0, **QUIET).start()
    yield tsrv, jsrv
    tsrv.stop()
    jsrv.stop()


def _stream(srv, tokens, max_new):
    req = urllib.request.Request(
        _url(srv, "/generate"),
        data=json.dumps({"tokens": tokens, "stream": True,
                         "max_new": max_new}).encode())
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in r.read().splitlines()
                if line.strip()]


def test_ndjson_stream_matches_jax_and_unary(cb_pair):
    tsrv, jsrv = cb_pair
    prompt = [3, 1, 4, 1, 5]
    got, want = _stream(tsrv, prompt, 6), _stream(jsrv, prompt, 6)
    toks = [ev["token"] for ev in got if "token" in ev]
    assert toks == [ev["token"] for ev in want if "token" in ev]
    assert [ev["i"] for ev in got if "token" in ev] == list(range(6))
    assert got[-1]["done"] and got[-1]["tokens"] == toks
    assert set(got[-1]) == set(want[-1])
    assert got[-1]["finish"] == want[-1]["finish"] == "length"
    unary = tsrv.generate(np.array(prompt, np.int32), max_new=6)
    assert unary["tokens"] == toks
    assert set(unary) == set(jsrv.generate(np.array(prompt, np.int32),
                                           max_new=6))
    # an inadmissible stream keeps its status code
    code, _, _ = _post(tsrv, "/generate", {"tokens": list(range(1, 20)),
                                           "stream": True})
    assert code == 400


# -- admission control and deadlines on a stand-in engine, both packages -----

class _StallEngine:
    """Engine stand-in whose run_batch blocks on an event — lets the
    queue fill and deadlines pass deterministically."""

    def __init__(self, spec, stats):
        self.spec = spec
        self.stats = stats
        self.params = {"w": np.zeros(1)}
        self.params_step = 0
        self.release = threading.Event()
        self.calls = []

    def hold(self):
        eng = self

        class _Hold:
            def __enter__(self):
                return eng.params, eng.params_step

            def __exit__(self, *exc):
                return False
        return _Hold()

    def run_batch(self, mode, tokens, plens, params=None):
        self.calls.append((mode, tokens.shape, tuple(plens.tolist())))
        self.release.wait(WAIT)
        if mode == "predict":
            return np.zeros((tokens.shape[0], VOCAB), np.float32)
        return np.zeros((tokens.shape[0], self.spec.max_new_tokens),
                        np.int32)


PKG = {"torch": (tbatcher, ServeSpec, ServeStats, tfaults),
       "jax": (jbatcher, JSpec, JStats, jfaults)}


def _stalled(pkg, **spec_kw):
    batcher, Spec, Stats, _ = PKG[pkg]
    eng = _StallEngine(Spec(**spec_kw), Stats())
    return eng, batcher.MicroBatcher(eng, log_fn=lambda s: None)


@pytest.mark.parametrize("pkg", list(PKG))
def test_queue_full_sheds_with_backoff_hint(pkg):
    eng, mb = _stalled(pkg, buckets=((1, 8),), queue_capacity=2,
                       batch_window_s=0.01)
    mb.start()
    try:
        first = mb.submit([1, 2])
        # wait until it is IN FLIGHT
        assert _until(lambda: eng.calls), \
            "dispatch loop never picked up the request"
        tickets = [first] + [mb.submit([1, 2]) for _ in range(2)]
        delays = []
        for _ in range(3):
            with pytest.raises(PKG[pkg][0].Overloaded) as ei:
                mb.submit([1, 2])
            delays.append(ei.value.retry_after)
        assert eng.stats.shed == 3
        assert delays[0] < delays[-1]
        eng.release.set()
        for t in tickets:
            t.wait(WAIT)
        assert eng.stats.completed == 3
    finally:
        eng.release.set()
        mb.stop()


@pytest.mark.parametrize("pkg", list(PKG))
def test_admit_fault_sheds_request(pkg):
    faults = PKG[pkg][3]
    eng, mb = _stalled(pkg, buckets=((1, 8),))
    eng.release.set()
    mb.start()
    try:
        with faults.inject(faults.FaultSchedule.parse("serve.admit@0:error")):
            with pytest.raises(PKG[pkg][0].Overloaded,
                               match="admission fault"):
                mb.submit([1, 2])
        assert eng.stats.shed == 1 and eng.stats.submitted == 0
        assert mb.submit([1, 2]).wait(WAIT)["step"] == 0
    finally:
        mb.stop()


@pytest.mark.parametrize("pkg", list(PKG))
def test_deadline_expires_in_queue(pkg):
    eng, mb = _stalled(pkg, buckets=((1, 8),), batch_window_s=0.0)
    mb.start()
    try:
        blocker = mb.submit([1, 2], timeout=30.0)   # occupies dispatch
        time.sleep(0.05)
        doomed = mb.submit([3, 4], timeout=0.05)    # expires queued
        time.sleep(0.2)
        eng.release.set()
        blocker.wait(WAIT)
        with pytest.raises(PKG[pkg][0].DeadlineExpired):
            doomed.wait(WAIT)
        assert eng.stats.expired == 1
    finally:
        eng.release.set()
        mb.stop()


@pytest.mark.parametrize("pkg", list(PKG))
def test_failed_batch_leaves_the_server_up(pkg):
    faults = PKG[pkg][3]
    eng, mb = _stalled(pkg, buckets=((1, 8),))
    eng.release.set()
    mb.start()
    try:
        with faults.inject(faults.FaultSchedule.parse("serve.batch@0:error")):
            t1 = mb.submit([1, 2])
            with pytest.raises(faults.FaultError):
                t1.wait(WAIT)
            assert eng.stats.failed == 1
            assert eng.stats.consecutive_batch_failures == 1
            mb.submit([1, 2]).wait(WAIT)
        assert eng.stats.completed == 1
        assert eng.stats.consecutive_batch_failures == 0
    finally:
        mb.stop()


@pytest.mark.parametrize("pkg", list(PKG))
def test_unservable_prompt_rejected(pkg):
    eng, mb = _stalled(pkg, buckets=((2, 8),))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        mb.submit(np.arange(9))
    with pytest.raises(ValueError, match="empty"):
        mb.submit([])
    with pytest.raises(ValueError, match="unknown mode"):
        mb.submit([1], mode="score")
    assert eng.stats.rejected == 3


# -- checkpoints: load, hot reload, health -----------------------------------

@pytest.fixture(params=["jax", "torch"])
def writer(request, monkeypatch):
    """save(ws, step, arrays, verdict) through one package's manager."""
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)

    def save(ws, step, arrays, verdict="ok"):
        health = None if verdict is None else {"verdict": verdict}
        opt = {"t": np.zeros((), np.float32)}
        if request.param == "jax":
            jckpt.CheckpointManager(ws, log_fn=lambda s: None).save(
                step, arrays, opt, health=health)
        else:
            tckpt.CheckpointManager(ws, log_fn=lambda s: None).save(
                step, {k: torch.from_numpy(v) for k, v in arrays.items()},
                opt, health=health)
    save.kind = request.param
    return save


def _engines(ws, fallback=None, **kw):
    """The port's engine and the JAX one over the same workspace."""
    jnet, tnet = _nets()
    spec = dict(degraded_after=2)
    t = InferenceEngine(tnet, ServeSpec(**spec),
                        None if fallback is None
                        else _tparams(tnet, fallback),
                        device="cpu", workspace=ws, **QUIET, **kw)
    j = JEngine(jnet, JSpec(**spec), workspace=ws,
                params=None if fallback is None else _jparams(fallback),
                **QUIET, **kw)
    return t, j


def _same(engine, arrays):
    for k, v in arrays.items():
        np.testing.assert_array_equal(engine.params[k].numpy(), v)


def test_engine_loads_latest_healthy_checkpoint(writer, tmp_path):
    _, tnet = _nets()
    p1, p2 = _arrays(tnet), _arrays(tnet, scale=2.0)
    ws = str(tmp_path)
    writer(ws, 1, p1)
    writer(ws, 2, p2, verdict=None)          # no verdict counts as ok
    writer(ws, 3, p1, verdict="diverged")    # the latest is bad
    t, j = _engines(ws)
    assert t.load() == j.load() == 2
    _same(t, p2)
    assert t.health() == j.health()


def test_reload_outcome_sequence_matches_jax(writer, tmp_path):
    _, tnet = _nets()
    p = {s: _arrays(tnet, seed=s) for s in range(1, 6)}
    ws = str(tmp_path)
    writer(ws, 1, p[1])
    t, j = _engines(ws)
    assert t.load() == j.load() == 1

    def both(call, *args, **kw):
        got = getattr(t, call)(*args, **kw)
        assert got == getattr(j, call)(*args, **kw), call
        return got

    assert both("poll_reload") == "unchanged"
    writer(ws, 2, p[2])
    assert both("poll_reload") == "reloaded"
    assert t.params_step == 2 and t.stats.reloads == 1
    _same(t, p[2])
    writer(ws, 3, p[3], verdict="nonfinite")
    assert both("poll_reload") == "refused"
    assert t.params_step == 2 and t.stats.reloads_refused == 1
    assert both("poll_reload") == "unchanged"
    writer(ws, 4, p[4])
    with tfaults.inject(tfaults.FaultSchedule.parse("serve.reload@0:error")), \
            jfaults.inject(jfaults.FaultSchedule.parse(
                "serve.reload@0:error")):
        assert both("poll_reload") == "failed"
    assert t.params_step == 2 and t.stats.reload_failures == 1
    assert both("poll_reload") == "reloaded"
    assert t.params_step == 4
    _same(t, p[4])
    assert t.health() == j.health()
    # a restore fault inside the checkpoint manager degrades the same way
    writer(ws, 5, p[5])
    with tfaults.inject(tfaults.FaultSchedule.parse("ckpt.restore@0:error")), \
            jfaults.inject(jfaults.FaultSchedule.parse(
                "ckpt.restore@0:error")):
        assert both("poll_reload") == "failed"
    assert both("poll_reload") == "reloaded"
    _same(t, p[5])


def test_reload_to_rollback_and_pinned_match_jax(writer, tmp_path):
    _, tnet = _nets()
    p = {s: _arrays(tnet, seed=s) for s in range(0, 6)}
    ws = str(tmp_path)
    writer(ws, 1, p[1])
    writer(ws, 5, p[5])
    t, j = _engines(ws, fallback=p[0], pinned=True)
    assert t.load() == j.load() == 5
    writer(ws, 6, p[1])
    assert t.poll_reload() == j.poll_reload() == "pinned"
    assert t.reload_to(1) == j.reload_to(1) == "reloaded"
    _same(t, p[1])
    assert t.reload_to(1) == j.reload_to(1) == "unchanged"
    # step -1: the fresh-init fallback, a host copy of the constructor's
    assert t.reload_to(-1) == j.reload_to(-1) == "reloaded"
    assert t.params_step == -1
    _same(t, p[0])
    assert t.reload_to(-1) == j.reload_to(-1) == "unchanged"
    assert t.reload_to(5) == j.reload_to(5) == "reloaded"
    _same(t, p[5])
    # the previous params (step -1) left no snapshot: restoring step 0
    # finds nothing on disk and is refused on both
    assert t.reload_to(0) == j.reload_to(0) == "refused"
    assert t.health()["ok"] is False and t.health() == j.health()
    # step 1 leaves the disk while the engine serves 5 after serving 1
    assert t.reload_to(1) == j.reload_to(1) == "reloaded"
    assert t.reload_to(5) == j.reload_to(5) == "reloaded"
    os.remove(os.path.join(ws, "checkpoints", "step_1.npz"))
    assert t.reload_to(1) == j.reload_to(1) == "reloaded"   # from memory
    assert t.params_step == 1
    _same(t, p[1])
    assert t.health() == j.health() and t.health()["pinned"] is True
    # an engine without a workspace refuses every explicit reload
    _, tnet2 = _nets()
    bare = InferenceEngine(tnet2, ServeSpec(), _tparams(tnet2, p[0]),
                           device="cpu", **QUIET)
    assert bare.reload_to(1) == "refused"
    assert bare.poll_reload() == "unchanged"


def test_reload_waits_for_the_batch_that_holds_the_engine(tmp_path):
    _, tnet = _nets()
    p1, p2 = _arrays(tnet), _arrays(tnet, seed=7)
    ws = str(tmp_path)
    tckpt.CheckpointManager(ws).save(1, p1, OPT)
    eng = InferenceEngine(tnet, ServeSpec(buckets=((2, 4),),
                                          max_new_tokens=3),
                          device="cpu", workspace=ws, **QUIET)
    assert eng.load() == 1
    live = eng.params
    toks, plens = np.array([[1, 2, 3, 4], [0, 0, 5, 6]], np.int32), \
        np.array([4, 2], np.int32)
    ref1 = eng.run_batch("generate", toks, plens)
    tckpt.CheckpointManager(ws).save(2, p2, OPT)
    outcome = []
    with eng.hold() as (params, step):
        reloader = threading.Thread(
            target=lambda: outcome.append(eng.poll_reload()))
        reloader.start()
        reloader.join(0.3)
        assert reloader.is_alive(), "the reload did not wait"
        assert step == eng.params_step == 1
        np.testing.assert_array_equal(
            eng.run_batch("generate", toks, plens, params=params), ref1)
    reloader.join(WAIT)
    assert not reloader.is_alive() and outcome == ["reloaded"]
    assert eng.params is live          # same tensors, new values
    assert eng.params_step == 2 and eng.reload_copy_ms is not None
    _same(eng, p2)
    fresh = InferenceEngine(tnet, ServeSpec(buckets=((2, 4),),
                                            max_new_tokens=3),
                            _tparams(tnet, p2), device="cpu", **QUIET)
    np.testing.assert_array_equal(eng.run_batch("generate", toks, plens),
                                  fresh.run_batch("generate", toks, plens))


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing", "extra"])
def test_geometry_mismatch_refused_with_live_tensors_unchanged(
        writer, tmp_path, bad):
    _, tnet = _nets()
    p1 = _arrays(tnet)
    p2 = _arrays(tnet, seed=3)
    k = sorted(p2)[-1]
    if bad == "shape":
        p2[k] = np.zeros(p2[k].shape + (2,), np.float32)
    elif bad == "dtype":
        p2[k] = p2[k].astype(np.float64)
    elif bad == "missing":
        del p2[k]
    else:
        p2["extra/w"] = np.zeros(3, np.float32)
    ws = str(tmp_path)
    writer(ws, 1, p1)
    t, j = _engines(ws)
    t.load(), j.load()
    before = {k: v.clone() for k, v in t.params.items()}
    writer(ws, 2, p2)
    got = t.poll_reload()
    assert got == "failed"
    if bad == "shape":
        assert j.poll_reload() == got
    assert t.params_step == 1 and t.stats.reload_failures == 1
    for name, v in t.params.items():
        assert torch.equal(v, before[name]), name
    assert t.health()["ok"] is False
    assert "reload failed" in t.health()["reasons"][0]


def test_health_degrades_on_stale_params_and_poll_deaths(tmp_path):
    _, tnet = _nets()
    ws = str(tmp_path)
    tckpt.CheckpointManager(ws).save(1, _arrays(tnet), OPT)
    eng = InferenceEngine(tnet, ServeSpec(buckets=((1, 4),),
                                          max_new_tokens=2,
                                          degraded_after=2,
                                          reload_poll_s=0.01),
                          device="cpu", workspace=ws, **QUIET)
    srv = InferenceServer(eng, port=0, **QUIET).start()
    try:
        code, body = _get(srv, "/healthz")
        assert code == 200 and json.loads(body)["step"] == 1
        # a diverged newer snapshot: refused, /healthz turns 503
        tckpt.CheckpointManager(ws).save(2, _arrays(tnet, seed=2), OPT,
                                         health={"verdict": "diverged"})
        assert _until(lambda: eng.stats.reloads_refused)
        code, body = _get(srv, "/healthz")
        h = json.loads(body)
        assert code == 503 and h["status"] == "degraded"
        assert "reload refused" in h["reasons"][0] and h["step"] == 1
        assert srv.generate([1, 2])["step"] == 1     # still serving
        # the supervised poll loop counts its deaths and restarts
        def die():
            raise OSError("poll died")
        eng.poll_reload = die
        assert _until(lambda: eng.stats.reload_poll_deaths >= 2)
        assert any("reload poll died" in r
                   for r in eng.health()["reasons"])
        eng.note_poll_ok()
        assert not any("reload poll died" in r
                       for r in eng.health()["reasons"])
        # /admin/reload is the explicit channel
        code, _, out = _post(srv, "/admin/reload", {"step": 1})
        assert code == 200 and out == {"outcome": "unchanged", "step": 1}
    finally:
        srv.stop()


def test_stats_snapshot_fields_match_jax():
    snaps = []
    for st in (ServeStats(), JStats()):
        st.count("submitted", 3)
        st.observe_batch(3, 4)
        for ms in (1.0, 2.0, 100.0):
            st.observe_latency(ms / 1e3)
        st.observe_request(0.001, 0.002, 4)
        st.observe_cb_step(2, 5)
        st.observe_batch_failure()
        snaps.append(st.snapshot())
    got, want = snaps
    assert set(got) == set(want)
    clocked = {"qps", "qps_recent", "uptime_s"}
    assert {k: v for k, v in got.items() if k not in clocked} == \
        {k: v for k, v in want.items() if k not in clocked}
    assert got["completed"] == 3 and got["batch_occupancy"] == 0.75
    assert got["p50_latency_ms"] == 2.0 and got["p95_latency_ms"] == 100.0
    assert got["qps"] > 0


def test_a_poll_between_a_save_and_its_verdict_waits(writer, tmp_path):
    """A save renames its snapshot into place and then records its
    health verdict in the manifest; a poll in between used to take a
    diverged snapshot for a healthy one and serve it until the next
    poll.  Such a poll is torn now: "unchanged", counted, and the next
    one sees the verdict and refuses."""
    _, tnet = _nets()
    ws = str(tmp_path)
    writer(ws, 1, _arrays(tnet))
    t, _ = _engines(ws)
    assert t.load() == 1
    writer(ws, 2, _arrays(tnet, seed=2), verdict="diverged")
    man_path = os.path.join(ws, "checkpoints", "MANIFEST.json")
    with open(man_path) as f:
        man = json.load(f)
    entry = man.pop("step_2.npz")
    with open(man_path, "w") as f:          # the moment between the two
        json.dump(man, f)
    assert t.poll_reload() == "unchanged"
    assert t.params_step == 1 and t.stats.torn_polls == 1
    man["step_2.npz"] = entry
    with open(man_path, "w") as f:
        json.dump(man, f)
    assert t.poll_reload() == "refused"
    assert t.params_step == 1
