"""Mid-stream failover and the control plane's durability in the port
(`singa_tpu_torch/serve/{router,session,sessionlog,wire}.py`), held
against the JAX package's.

- On scriptable stream stubs each package's `Router` splices a stream
  whose engine dies, stalls or is stale, and their session counters and
  spliced streams are equal.
- On real engines on the CPU (a tiny dense LM, 2 layers, E=32, V=64,
  f32, cb=on): a killed engine's stream is spliced onto its sibling
  exactly once and bit-identical to the uninterrupted one, as
  `tests/test_failover.py` holds the JAX scheduler; re-admitting
  (prompt ‖ prefix) with `resume_from=k` through each of the port's four
  engine handles (in-process, HTTP, binary wire, negotiating) gives the
  uninterrupted suffix numbered from k; a router restart and a handoff
  resume a journaled stream exactly once.
- The WAL and the control-state file that either package writes replay
  in the other.
- A real `serve --pinned --wire` worker process is adopted with
  `transport="auto"` (it negotiates the wire) by `EngineFleet.
  from_hostfile` and by the CLI's `--fleet_hostfile`, and the port's
  `Router` adopts a JAX server over HTTP and the wire.

Every socket listens on port 0 and every wait has a timeout."""

import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import singa_tpu.serve as jserve
import singa_tpu.serve.sessionlog as jlog
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm

import singa_tpu_torch.main as tmain
import singa_tpu_torch.serve as tserve
import singa_tpu_torch.serve.sessionlog as tlog
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.serve import (BinaryEngineHandle, EngineFleet,
                                   HttpEngineHandle, InferenceEngine,
                                   InferenceServer, LameDuck,
                                   LocalEngineHandle,
                                   NegotiatingEngineHandle, Router,
                                   RouterSpec, ServeSpec)
from singa_tpu_torch.serve.router import _accepted_kwargs
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
PKGS = {"jax": SimpleNamespace(serve=jserve, log=jlog),
        "torch": SimpleNamespace(serve=tserve, log=tlog)}
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
CB = dict(buckets=((2, SEQ),), max_new_tokens=12, batch_window_s=0.002,
          request_timeout_s=60.0, cb="on", cb_slots=3, cb_block_len=4)
QUIET = dict(log_fn=lambda s: None)
WAIT = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONF = os.path.join(REPO, "examples", "transformer", "lm_tiny.conf")
PROMPT = np.array([3, 1, 4, 1], np.int32)


# -- stream stubs ------------------------------------------------------------

def _tok(step, j):
    """Token at absolute index j: a function of (step, j) only, as
    greedy decode is of (fingerprint, prefix)."""
    return (int(step) * 7 + j * 3) % 101


class StreamStub:
    """Engine handle whose `request_stream` speaks the indexed protocol
    and can be scripted to die or stall at an absolute token index."""

    def __init__(self, name, step=1):
        self.name = name
        self.step = step
        self.die_at = None
        self.stall_at = None
        self.calls = []

    def probe(self):
        return {"ok": True, "status": "ok", "step": self.step,
                "queue_depth": 0}

    def stats_snapshot(self):
        return {"completed": 0, "failed": 0, "expired": 0,
                "p95_latency_ms": None}

    def request(self, mode, tokens, timeout=None):
        return {"tokens": [1], "step": self.step}

    def request_stream(self, tokens, timeout=None, max_new=None,
                       deadline=None, priority="interactive",
                       cancel_event=None, resume_from=0):
        self.calls.append((int(resume_from), len(tokens)))

        def gen():
            for j in range(int(resume_from), int(max_new)):
                if self.die_at == j:
                    self.die_at = None
                    raise RuntimeError(f"{self.name} exploded at {j}")
                if self.stall_at == j:
                    self.stall_at = None
                    if cancel_event is not None:
                        cancel_event.wait(10.0)
                    return
                yield {"token": _tok(self.step, j), "i": j}
            yield {"done": True, "finish": "length", "step": self.step,
                   "tokens": [_tok(self.step, j) for j in
                              range(int(resume_from), int(max_new))]}
        return gen()


SESSION_KEYS = ("opened", "done", "failed", "failovers", "resumed",
                "spliced", "dup_tokens", "gap_events", "idle_timeouts",
                "resume_denied", "failover_stale")


def _stub_stream(pkg, case):
    e0, e1 = StreamStub("e0"), StreamStub("e1", step=2 if case == "stale"
                                         else 1)
    if case == "stall":
        e0.stall_at = 2
    else:
        e0.die_at = 3
    r = pkg.serve.Router([e0, e1], spec=pkg.serve.RouterSpec(
        probe_period_s=60.0, quarantine_after=10, request_timeout_s=10.0,
        hedge="off", stream_idle_s=0.2 if case == "stall" else 0.0),
        **QUIET)
    r.probe_all()
    evs = list(r.route_stream([5, 6], max_new=8))
    snap = r.sessions.snapshot()
    done = evs[-1]
    return {"i": [ev["i"] for ev in evs if "token" in ev],
            "tokens": [ev["token"] for ev in evs if "token" in ev],
            "done": {k: done.get(k) for k in ("finish", "spliced",
                                              "resumes", "engine",
                                              "tokens")},
            "calls": (e0.calls, e1.calls),
            "sessions": {k: snap[k] for k in SESSION_KEYS}}


@pytest.mark.parametrize("case", ["die", "stall", "stale"])
def test_stub_streams_fail_over_as_the_jax_router_s(case):
    got = {name: _stub_stream(pkg, case) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    if case == "stale":
        assert t["done"]["finish"] == "failover_stale"
        assert t["sessions"]["failover_stale"] == 1
        return
    assert t["i"] == list(range(8))     # every index exactly once
    assert t["tokens"] == [_tok(1, j) for j in range(8)]
    assert t["done"]["spliced"] and t["done"]["resumes"] == 1
    assert t["sessions"]["dup_tokens"] == 0
    assert t["sessions"]["gap_events"] == 0


# -- real engines ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    net = build_net(transformer_lm(**CFG), "kTest", SHAPES)
    return net, numpy_params(net, seed=0)


def _params(tiny):
    net, arrays = tiny
    return params_from_numpy(net, arrays, device="cpu")


def _spliced_run(tiny, stall_s=0.03, kill_after=3):
    """A 2-engine cb fleet: an uninterrupted stream, then the same
    stream with its engine killed after `kill_after` tokens."""
    net, _ = tiny
    fleet = EngineFleet.local(
        net, ServeSpec(**CB), 2, params=_params(tiny),
        router_spec=RouterSpec(probe_period_s=60.0, quarantine_after=10,
                               request_timeout_s=WAIT, hedge="off"),
        device="cpu", **QUIET).start()
    try:
        ref = [ev["token"] for ev in fleet.generate_stream(
            PROMPT, max_new=12, timeout=WAIT) if "token" in ev]
        for n in fleet.router.names():
            fleet.router.handle_for(n).engine.set_stall(stall_s)
        seen, killed = [], None
        for ev in fleet.generate_stream(PROMPT, max_new=12, timeout=WAIT):
            if "token" in ev:
                seen.append(ev)
            if len(seen) == kill_after and killed is None:
                sess = fleet.router.sessions.snapshot()["sessions"]
                killed = sess[0]["engine"]
                fleet.router.handle_for(killed).kill()
            if ev.get("done"):
                done = ev
        return ref, seen, done, killed, fleet.router.sessions.snapshot()
    finally:
        fleet.stop()


def test_a_killed_engine_s_stream_is_spliced_bit_identical(tiny):
    ref, seen, done, killed, snap = _spliced_run(tiny)
    assert len(ref) == 12
    assert [ev["i"] for ev in seen] == list(range(12))
    assert [ev["token"] for ev in seen] == ref
    assert done["spliced"] and done["resumes"] == 1
    assert done["tokens"] == ref and done["engine"] != killed
    assert snap["spliced"] == 1 and snap["dup_tokens"] == 0
    assert snap["gap_events"] == 0


@pytest.fixture(scope="module")
def served(tiny):
    """A port server (cb=on, HTTP and the wire) and its uninterrupted
    greedy stream."""
    net, _ = tiny
    eng = InferenceEngine(net, ServeSpec(**CB), _params(tiny),
                          device="cpu", **QUIET)
    srv = InferenceServer(eng, port=0, wire_on=True, **QUIET).start()
    ref = srv.generate_stream(PROMPT).wait(WAIT)["tokens"]
    assert len(ref) == 12
    yield srv, ref
    srv.stop()


def _handle(kind, srv):
    host, port = srv.address
    url = f"http://{host}:{port}"
    if kind == "local":
        return LocalEngineHandle("e", srv)
    if kind == "http":
        return HttpEngineHandle("e", url)
    if kind == "binary":
        return BinaryEngineHandle("e", srv.wire_address)
    h = NegotiatingEngineHandle("e", url, **QUIET)
    h.probe()
    assert h.transport == "binary"
    return h


@pytest.mark.parametrize("kind", ["local", "http", "binary", "negotiating"])
def test_every_port_handle_accepts_resume_from(served, kind):
    srv, ref = served
    h = _handle(kind, srv)
    try:
        assert "resume_from" in _accepted_kwargs(h.request_stream)
        k = 5
        evs = list(h.request_stream(np.concatenate([PROMPT, ref[:k]]),
                                    timeout=WAIT, max_new=12,
                                    resume_from=k))
        toks = [ev for ev in evs if "token" in ev]
        assert [ev["i"] for ev in toks] == list(range(k, 12))
        assert [ev["token"] for ev in toks] == ref[k:]
        assert evs[-1]["done"]
    finally:
        if kind != "local":
            h.close()


# -- the WAL and the control state across the packages ------------------------

def _write_wal(pkg, d):
    w = pkg.log.SessionWal(d, 1, group_tokens=4, group_ms=5.0, **QUIET)
    w.append_open("s1-1", [5, 6], 8, "interactive", "acme", None, 3, 12.5)
    for i, t in enumerate([10, 11, 12]):
        w.append_tok("s1-1", i, t)
    w.append_resume("s1-1", "engine-1", 3)
    w.append_open("s1-2", [7], 4, "batch", "default", "fam", 3, None)
    w.append_tok("s1-2", 0, 42)
    w.append_tok("s1-2", 0, 42)         # a duplicate append folds
    w.append_close("s1-2", "done")
    w.close()
    store = pkg.log.ControlStateStore(d)
    assert store.save({"epoch": 1, "router": {"members": {"e0": {
        "strikes": 2}}}, "rollout": {"pinned_step": 3}})
    return pkg.log.wal_path(d, 1)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_wal_and_control_state_cross_read(writer, reader, tmp_path):
    path = _write_wal(PKGS[writer], str(tmp_path))
    r = PKGS[reader].log
    header, records, torn = r.replay_wal(path)
    assert not torn and header["epoch"] == 1 and header["ver"] == 1
    jh, jrecords, _ = jlog.replay_wal(path)
    assert records == jrecords
    red = r.reduce_sessions(records)
    assert red == jlog.reduce_sessions(jrecords)
    assert red["s1-1"]["emitted"] == [10, 11, 12]
    assert red["s1-1"]["resumes"] == 1 and red["s1-1"]["terminal"] is None
    assert red["s1-2"]["terminal"] == "done" and red["s1-2"]["emitted"] == [42]
    chk = r.walcheck(path)
    assert chk == jlog.walcheck(path)
    assert chk["live_sessions"] == 1 and chk["journaled_tokens"] == 4
    assert r.ControlStateStore(str(tmp_path)).load()["rollout"] == {
        "pinned_step": 3}


def _tool(path):
    """A top-level script of tools/ as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3] + "_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_walcheck_tool_reads_either_package_s_journal(writer, tmp_path,
                                                      capsys):
    from singa_tpu_torch.tools import walcheck as twalcheck
    jwalcheck = _tool(os.path.join(REPO, "tools", "walcheck.py"))
    _write_wal(PKGS[writer], str(tmp_path))
    out = {}
    for name, tool in (("jax", jwalcheck), ("torch", twalcheck)):
        assert tool.main([str(tmp_path), "--records"]) == 0
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert json.loads(out["torch"].split("\n}\n")[0] + "}")[
        "live_sessions"] == 1
    assert twalcheck.main([str(tmp_path / "none")]) == 1


# -- router restart and handoff -------------------------------------------------

def _wal_fleet(tiny, ws, standby=False):
    net, _ = tiny
    spec = ServeSpec(**dict(CB, max_new_tokens=8))
    rspec = RouterSpec(probe_period_s=0.1, hedge="off",
                       request_timeout_s=WAIT, wal_group_tokens=4,
                       wal_group_ms=5.0, state_snapshot_s=0.1)
    return EngineFleet.local(net, spec, 1, workspace=ws,
                             params=_params(tiny), router_spec=rspec,
                             standby=standby, device="cpu", **QUIET)


def test_router_restart_and_handoff_resume_exactly_once(tiny):
    """A stream cut by a router crash (the fleet abandoned, never
    stopped, as SIGKILL leaves it) resumes on the successor over the
    same workspace exactly once, equal to the uninterrupted stream; a
    handoff fences the old router and its journal replays on the
    promoted standby."""
    _, arrays = tiny
    with tempfile.TemporaryDirectory() as ws:
        CheckpointManager(ws, log_fn=lambda s: None).save(
            1, arrays, {"t": np.zeros((), np.float32)},
            health={"verdict": "ok"})
        f0 = _wal_fleet(tiny, ws).start()
        assert f0.epoch == 1
        ref = [ev["token"] for ev in f0.generate_stream(PROMPT, max_new=8)
               if "token" in ev]
        assert len(ref) == 8
        f0.stop()

        f1 = _wal_fleet(tiny, ws).start()
        assert f1.epoch == 2
        stream = f1.generate_stream(PROMPT, max_new=8)
        seen, sid = [], None
        for ev in stream:
            if sid is None and "sid" in ev:
                sid = ev["sid"]
            if "token" in ev:
                seen.append(ev["token"])
            if len(seen) >= 3:
                break
        assert sid is not None and sid.startswith("s2-")
        f1.wal.flush()

        f2 = _wal_fleet(tiny, ws).start()
        assert f2.epoch == 3
        out = list(f2.router.attach_stream(sid, resume_from=len(seen)))
        toks = [ev["token"] for ev in out if "token" in ev]
        done = [ev for ev in out if ev.get("done")][0]
        assert seen + toks == ref and done["tokens"] == ref
        assert done["spliced"] and done["finish"] == "length"
        assert f2.wal_stats.snapshot()["recovered_streams"] == 1
        f1.wal.append_close(sid, "done")
        f1.wal.flush()
        assert f1.wal.fenced
        assert f1.wal_stats.snapshot()["fenced_writes"] >= 1

        f3 = _wal_fleet(tiny, ws, standby=True).start()
        assert f3.standby and f3.wal is None
        got = f2.handoff(successor="http://standby:9")
        assert got["lame_duck"] and f2.wal.fenced
        with pytest.raises(LameDuck):
            f2.generate(PROMPT)
        promoted = f3.promote_standby()
        assert f3.epoch == 4 and promoted["terminal"] >= 1
        assert [e["token"] for e in f3.router.attach_stream(
            sid, resume_from=0) if "token" in e] == ref
        assert f3.generate(PROMPT)["step"] == 1
        f3.stop()
        f2.stop()
        stream.close()
        f1.stop()


# -- processes -------------------------------------------------------------------

WORKER_SPEC = "buckets=2x16,max_new_tokens=6,cb=on,cb_slots=2,cb_block_len=4"
WORKER = ("import sys; from singa_tpu_torch.main import main; "
          "sys.exit(main(sys.argv[1:], device='cpu'))")


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """A `serve --pinned --wire` worker process on lm_tiny.conf."""
    log = tmp_path_factory.mktemp("worker") / "log"
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env.pop("PYTHONPATH", None)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", WORKER, "serve", "-model_conf",
             TINY_CONF, "--serve_spec",
             WORKER_SPEC,
             "--port", "0", "--pinned", "--wire"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90.0
        url = None
        while url is None:
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            text = log.read_text()
            if "wire on" in text:
                for line in text.splitlines():
                    if "serve: http on " in line:
                        url = "http://" + line.split("http on ")[1].split()[0]
            time.sleep(0.1)
        yield url
    finally:
        proc.kill()
        proc.wait(10)


def test_a_worker_process_is_adopted_over_the_wire(worker, tmp_path,
                                                   capsys):
    hosts = tmp_path / "hosts"
    hosts.write_text(worker.split("//", 1)[1] + "\n")
    fleet = EngineFleet.from_hostfile(
        str(hosts), router_spec=RouterSpec(probe_period_s=60.0,
                                           hedge="off",
                                           request_timeout_s=WAIT),
        transport="auto", **QUIET).start()
    try:
        h = fleet.router.handle_for("engine-0")
        assert isinstance(h, NegotiatingEngineHandle)
        assert h.transport == "binary"
        out = fleet.generate(PROMPT, timeout=WAIT)
        evs = list(fleet.generate_stream(PROMPT, timeout=WAIT, max_new=6))
        assert [ev["token"] for ev in evs if "token" in ev] == out["tokens"]
        assert h.http.request("generate", PROMPT,
                              timeout=WAIT)["tokens"] == out["tokens"]
        assert h.transport == "binary"
    finally:
        fleet.stop()
    argv = ["serve", "-model_conf", TINY_CONF, "--serve_spec", WORKER_SPEC,
            "--fleet_hostfile", str(hosts), "--transport", "auto",
            "--smoke", "3"]
    assert tmain.main(argv, device="cpu") == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["completed"] == 3 and snap["failed"] == 0


@pytest.mark.parametrize("transport", ["http", "wire"])
def test_the_port_router_adopts_a_jax_server(tiny, transport):
    _, arrays = tiny
    jnet = jbuild_net(jtransformer_lm(**CFG), "kTest", SHAPES)
    jeng = jserve.InferenceEngine(
        jnet, jserve.ServeSpec(**CB),
        params={k: jnp.asarray(v) for k, v in arrays.items()}, **QUIET)
    jsrv = jserve.InferenceServer(jeng, port=0, wire_on=True,
                                  **QUIET).start()
    try:
        host, port = jsrv.address
        url = f"http://{host}:{port}"
        handle = (HttpEngineHandle("jax-0", url) if transport == "http"
                  else NegotiatingEngineHandle("jax-0", url, **QUIET))
        r = Router([handle], spec=RouterSpec(
            probe_period_s=60.0, request_timeout_s=WAIT, hedge="off"),
            **QUIET)
        try:
            r.probe_all()
            if transport == "wire":
                assert handle.transport == "binary"
            want = jsrv.generate(PROMPT)["tokens"]
            assert r.route("generate", PROMPT,
                           timeout=WAIT)["tokens"] == want
            evs = list(r.route_stream(PROMPT, timeout=WAIT, max_new=12))
            assert [ev["token"] for ev in evs if "token" in ev] == want
        finally:
            r.stop()
            handle.close()
    finally:
        jsrv.stop()
