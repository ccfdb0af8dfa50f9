"""The port's `obs` layer (`singa_tpu_torch/obs/`) held against the JAX
package's (`singa_tpu/obs/`) on the same inputs: Prometheus text
rendered by each package and parsed by the other, span trees with
their correlation and trace ids, event-log lines, flight-recorder dumps
and `ObsSpec.parse`, each one test parametrised over both packages.
Ids, timestamps, durations, pids and thread ids are random or clocked,
so they are compared by structure (which span is whose parent, which
spans share a trace), everything else exactly.  Then what the port
changed: `perf` counts CUDA-graph captures per program, a capture after
`warmup()` is the recompile anomaly, and `device_memory()` is empty on
the CPU."""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import singa_tpu.obs as jobs
import singa_tpu_torch.obs as tobs
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.obs import perf as tperf
from singa_tpu_torch.serve import InferenceEngine, ServeSpec
from singa_tpu_torch.serve import engine as tengine_mod
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
PKGS = {"jax": jobs, "torch": tobs}
PAIRS = [(a, b) for a in PKGS for b in PKGS]


def _fill(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("requests.total", "requests served")
    c.inc(3)
    g = reg.gauge("queue-depth", "queued requests")
    g.set(7.5)
    h = reg.histogram("latency_seconds", "request latency")
    for v in (0.0004, 0.003, 0.02, 0.2, 1.5, 30.0):
        h.observe(v)
    Sample = pkg.Sample

    def collect():
        return [Sample("tenant_shed_total", "counter", "sheds", 2.0,
                       (("tenant", "a"),)),
                Sample("tenant_shed_total", "counter", "sheds", 5.0,
                       (("tenant", 'b"q'),)),
                Sample("nan_gauge", "gauge", "not a number",
                       float("nan"))]
    reg.register_collector(collect)
    return reg


@pytest.mark.parametrize("render,parse", PAIRS)
def test_prometheus_text_crosses_between_packages(render, parse):
    text = _fill(PKGS[render]).render_prometheus()
    assert text == _fill(jobs).render_prometheus()
    got = PKGS[parse].parse_prometheus(text)
    want = jobs.parse_prometheus(text)
    assert set(got) == set(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == want[k], k
    assert got["requests_total"] == 3.0
    assert got['tenant_shed_total{tenant="a"}'] == 2.0


def _structure(events):
    """Span events with their random and clocked fields replaced by
    their roles: ids by order of first appearance, traces likewise."""
    ids, traces = {}, {}
    out = []
    for ev in sorted(events, key=lambda e: e["args"]["span_id"]):
        ids.setdefault(ev["args"]["span_id"], len(ids))
    for ev in sorted(events, key=lambda e: e["args"]["span_id"]):
        a = dict(ev["args"])
        a["span_id"] = ids[a["span_id"]]
        if "parent_id" in a:
            a["parent_id"] = ids.get(a["parent_id"], "remote")
        a["trace"] = traces.setdefault(a["trace"], len(traces))
        out.append((ev["name"], ev["ph"], ev["cat"],
                    tuple(sorted(a.items()))))
    return out


def _spans(pkg):
    tr = pkg.Tracer(max_spans=5)
    with tr.span("serve.request", corr="req-1", mode="generate") as sp:
        sp.set(tokens=4)
        ctx = tr.context()
        with tr.span("batcher.admit"):
            assert tr.current_corr() == "req-1"
        with tr.span("batcher.dispatch", corr="batch-1",
                     reqs=["req-1"]):
            with tr.span("engine.run_batch", batch=2):
                pass
    # a cross-thread hand-off: the context re-anchors a span
    with tr.span("scheduler.prefill", trace=ctx[0], parent=ctx[1],
                 slot=0):
        pass
    try:
        with tr.span("engine.reload"):
            raise ValueError("boom")
    except ValueError:
        pass
    with tr.span("overflow"):      # past max_spans, as engine.reload
        pass
    tr.add_span("stream.stage", 0.0, 0.001, corr="req-9")
    assert tr.current() is None and tr.context() is None
    return tr


@pytest.mark.parametrize("pkg", list(PKGS))
def test_span_trees_and_correlation_match_jax(pkg):
    got, want = _spans(PKGS[pkg]), _spans(jobs)
    assert _structure(got.events()) == _structure(want.events())
    assert got.dropped == want.dropped == 3
    d = got.trace_dict()
    assert set(d) == set(want.trace_dict())
    assert [e["name"] for e in d["traceEvents"] if e["ph"] == "M"][0] \
        == "process_name"
    assert got.discard_trace(got.events()[0]["args"]["trace"]) == 5


def _event_lines(pkg, path):
    log = pkg.EventLog(path)
    log.emit("serve.reload", outcome="reloaded", step=10)
    log.emit("serve.shed", why="queue full", retry_after=0.05,
             arr=np.arange(3))
    log.close()
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_event_log_lines_match_jax(pkg, tmp_path):
    got = _event_lines(PKGS[pkg], str(tmp_path / "t.jsonl"))
    want = _event_lines(jobs, str(tmp_path / "j.jsonl"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and isinstance(g.pop("ts"), float)
        w.pop("ts")
        assert g == w


def fr_mod(pkg):
    return importlib.import_module(pkg.__name__ + ".flightrec")


def _dump(pkg, out_dir):
    fr = pkg.FlightRecorder(out_dir, ring=16, extra_fn=lambda: {"x": 1})
    tr = pkg.Tracer()
    with tr.span("engine.compile", mode="generate"):
        pass
    fr.observe("serve.reload", {"outcome": "refused", "step": 5})
    for i in range(fr_mod(pkg).SHED_STORM_N):
        path = fr.observe("serve.shed", {"why": "full", "n": i},
                          tracer=tr)
    assert path is not None and fr.dumps == 1
    # rate-limited per trigger
    assert fr.trigger("shed_storm") is None
    with open(path) as f:
        return os.path.basename(path), json.load(f)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_flight_recorder_dump_matches_jax(pkg, tmp_path):
    gname, got = _dump(PKGS[pkg], str(tmp_path / "t"))
    wname, want = _dump(jobs, str(tmp_path / "j"))
    assert gname == wname == "flightrec-shed_storm-1.json"
    assert set(got) == set(want)
    assert got["trigger"] == "shed_storm" and got["perf"] == {"x": 1}
    strip = [{k: v for k, v in e.items() if k != "ts"}
             for e in got["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in want["events"]]
    assert _structure(got["spans"]) == _structure(want["spans"])
    assert fr_mod(PKGS[pkg]).TRIGGER_KINDS == fr_mod(jobs).TRIGGER_KINDS


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("text", [
    None, "", "trace=/tmp/t.json,events=/tmp/e.jsonl",
    "metrics_period_s=5;max_spans=100000,trace_ring=65536,"
    "max_events_mb=64,process=worker-0,sample=tail,sample_slow_ms=250,"
    "flightrec=/tmp/fr,flightrec_ring=64",
    "bogus=1", "trace", "max_spans=lots", "sample=some",
])
def test_obs_spec_parses_like_jax(pkg, text):
    try:
        want = dataclasses.asdict(jobs.ObsSpec.parse(text))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PKGS[pkg].ObsSpec.parse(text)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(PKGS[pkg].ObsSpec.parse(text)) == want


@pytest.mark.parametrize("pkg", list(PKGS))
def test_session_api_matches_jax(pkg, tmp_path):
    o = PKGS[pkg]
    assert o.span("x") is o.NULL_SPAN and o.current_corr() is None
    assert o.trace_dump() == {"traceEvents": [], "displayTimeUnit": "ms"}
    spec = o.ObsSpec.parse(f"events={tmp_path}/e.jsonl,trace_ring=8")
    with o.session(spec) as sess:
        assert o.registry() is sess.registry
        with o.span("serve.request", corr="req-3"):
            assert o.current_corr() == "req-3"
            assert o.trace_context()[1] > 0
        o.emit_event("serve.cb_retire", corr="req-3", finish="eos")
        assert [e["name"] for e in o.trace_dump()["traceEvents"]
                if e["ph"] == "X"] == ["serve.request"]
        assert o.sample_trace(None, 0.1)
    assert o.active() is None
    with open(tmp_path / "e.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["serve.cb_retire", "obs.flush"]


def test_perf_counts_captures_and_flags_a_capture_after_warmup():
    w = tperf.PerfWatch()
    with w.compile_span("generate", geometry="b2_p8", scope="e1"):
        pass
    w.lookup_hit("generate")
    w.mark_warm("e1", "generate")
    # another program family is lazy, not anomalous; another scope too
    with w.compile_span("predict", geometry="b2_p8", scope="e1"):
        pass
    with w.compile_span("generate", geometry="b2_p8", scope="e2"):
        pass
    assert w.anomalies == 0
    with w.compile_span("cb_decode", scope="e1", family="generate"):
        pass
    assert w.anomalies == 1
    snap = w.snapshot()
    assert snap["compiles"] == {"generate": 2, "predict": 1,
                                "cb_decode": 1}
    assert snap["cache"] == {"generate:miss": 2, "generate:hit": 1,
                             "predict:miss": 1, "cb_decode:miss": 1}
    samples = {(s.name, s.labels): s.value for s in w.collect()}
    assert samples[("singa_compiles_total",
                    (("program", "generate"),))] == 2.0
    assert samples[("singa_recompile_anomalies_total", ())] == 1.0
    assert w.harvest("generate") == {}


def test_device_memory_is_empty_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the CPU answer is "
                    "checked where there is none")
    assert tperf.watch().device_memory() == []
    nbytes = tperf.watch().set_memory_tree(
        "serve_params", {"a": torch.zeros(3, 4), "b": {"c": np.zeros(5)}},
        scope="t")
    assert nbytes == 3 * 4 * 4 + 5 * 8


class _FakeGraph:
    """A StepGraph stand-in that runs eagerly on the CPU, so the
    engine's capture accounting runs here."""

    def __init__(self, name, pool, writes=(), generators=()):
        self.name, self.clone_bytes, self._seen = name, 0, set()

    def has(self, batch):
        return tuple(np.shape(batch["tokens"])) in self._seen

    def capture(self, fn, state, batch):
        self._seen.add(tuple(np.shape(batch["tokens"])))
        return True

    def __call__(self, fn, state, batch):
        return fn(state, {k: torch.from_numpy(np.asarray(v))
                          for k, v in batch.items()})


def test_engine_captures_are_compile_spans_and_late_ones_anomalies(
        monkeypatch):
    monkeypatch.setattr(tengine_mod, "StepGraph", _FakeGraph)
    watch = tperf.reset()
    cfg = transformer_lm(vocab_size=64, num_layers=1, embed_dim=16,
                         num_heads=2, head_dim=8, seq_len=8, batchsize=2)
    net = build_net(cfg, "kTest", {"data": {"input": (8,),
                                            "target": (8,)}})
    params = params_from_numpy(net, numpy_params(net, seed=0),
                               device="cpu")
    eng = InferenceEngine(net, ServeSpec(buckets=((2, 4), (2, 8)),
                                         max_new_tokens=2),
                          params, device="cpu", log_fn=lambda s: None)
    eng.graphs = True              # route through the stand-in graphs
    assert eng.warmup(("generate",)) == 2
    assert watch.snapshot()["compiles"] == {"generate": 2}
    eng.run_batch("generate", np.ones((2, 4), np.int32),
                  np.array([4, 1], np.int32))
    eng.run_batch("predict", np.ones((2, 4), np.int32),
                  np.array([4, 1], np.int32))
    assert watch.anomalies == 0 and eng.stats.compiles == 3
    assert watch.snapshot()["cache"]["generate:hit"] == 1
    # a geometry no bucket declares, captured after warmup
    eng.run_batch("generate", np.ones((1, 4), np.int32),
                  np.array([4], np.int32))
    assert watch.anomalies == 1
    assert watch.snapshot()["records"][-1]["anomaly"] is True
    tperf.reset()
