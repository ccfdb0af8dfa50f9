"""The port's tracing inside the program, on the CPU: `obs.span` on the
profiler's clock, the serving loop's program and host-gap counters
(`ServeStats.observe_call`, `cb_counters`), the device phases of a
replayed train step (`core/step_graph.py` marks, `TimerInfo.add_marks`)
and `singa_program_mfu` from the owners' call counters.  The marks
themselves are event-record nodes of a CUDA graph captured under an obs
session: `chip_smoke.py` phase 7 holds their phases against a replay's
length on the card."""

import contextlib
import gc
import json
import time

import numpy as np
import pytest
import torch

from singa_tpu_torch import obs
from singa_tpu_torch.core import step_graph
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import TimerInfo, Trainer
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.obs import perf
from singa_tpu_torch.serve import (ContinuousScheduler, InferenceEngine,
                                   ServeSpec)
from singa_tpu_torch.serve.stats import ServeStats
from singa_tpu_torch.utils import profiler
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
QUIET = dict(log_fn=lambda s: None)


def _annotations(path):
    with open(path) as f:
        return {e["name"]: e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"}


def test_span_lands_in_the_profilers_export(tmp_path):
    assert obs.active() is None
    assert obs.span("idle") is obs.NULL_SPAN
    with obs.session() as o, torch.profiler.profile() as prof:
        with obs.span("outer", step=1):
            with profiler.phase("fwd"):
                torch.ones(8).add_(1)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    got = _annotations(tmp_path / "t.json")
    outer, inner = got["outer"], got["singa::fwd"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the session's Tracer has them too, on its own clock
    names = [e["name"] for e in o.tracer.events()]
    assert names == ["singa::fwd", "outer"]
    assert obs.span("idle") is obs.NULL_SPAN


def test_scheduler_counts_programs_and_host_gaps():
    net = build_net(transformer_lm(**CFG), "kTest", SHAPES)
    params = params_from_numpy(net, numpy_params(net, seed=0),
                               device="cpu")
    spec = ServeSpec(buckets=((2, SEQ),), max_new_tokens=6, cb="on",
                     cb_slots=2, cb_block_len=4, request_timeout_s=30.0)
    eng = InferenceEngine(net, spec, params, device="cpu", **QUIET)
    sched = ContinuousScheduler(eng, **QUIET)
    decodes = [0]
    decode_step = sched._decode_step

    def counted(*a):
        decodes[0] += 1
        return decode_step(*a)
    sched._decode_step = counted
    rng = np.random.default_rng(0)

    def submit(n):
        return [sched.submit(rng.integers(1, VOCAB, 5 + i), max_new=6)
                for i in range(n)]

    with obs.session() as o:
        first = submit(3)             # queued before the loop starts
        sched.start()
        try:
            for t in first:
                t.wait(60.0)
            c1 = eng.stats.cb_counters()
            time.sleep(0.3)           # the loop idles: no gap
            c2 = eng.stats.cb_counters()
            for t in submit(2):
                t.wait(60.0)
            c3 = eng.stats.cb_counters()
        finally:
            sched.stop()
    calls1 = c1["prefill_calls"] + c1["decode_calls"]
    calls = c3["prefill_calls"] + c3["decode_calls"]
    assert c1["prefill_calls"] == 3 and c3["prefill_calls"] == 5
    assert c3["decode_calls"] == decodes[0] > 0
    assert c3["prefill_seconds"] > 0 and c3["decode_seconds"] > 0
    # one chain of calls a burst: a launch after a wait opens no gap
    assert c1["host_gaps"] == calls1 - 1
    assert c2 == c1
    assert c3["host_gaps"] == calls - 2
    assert 0 < c3["host_gap_seconds"] < 0.3
    assert eng.stats.program_calls() == {
        "cb_prefill": (5, c3["prefill_seconds"]),
        "cb_decode": (decodes[0], c3["decode_seconds"])}
    # the counters stay out of the snapshot (its fields are the JAX
    # package's) and reach /metrics
    assert set(eng.stats.snapshot()) == set(ServeStats().snapshot())
    reg = obs.MetricsRegistry()
    eng.stats.register_into(reg)
    got = obs.parse_prometheus(reg.render_prometheus())
    assert got["singa_serve_cb_decode_calls_total"] == decodes[0]
    assert got["singa_serve_cb_host_gaps_total"] == calls - 2
    spans = {e["name"] for e in o.tracer.events()}
    assert {"scheduler.iterate", "scheduler.expire",
            "scheduler.admit_pending", "scheduler.prefill",
            "scheduler.decode", "scheduler.emit", "scheduler.account",
            "engine.launch", "engine.fetch"} <= spans


def _tiny_lm_trainer():
    cfg = transformer_lm(**CFG)
    cfg.train_steps = 3
    return Trainer(cfg, SHAPES, device="cpu", seed=3, **QUIET)


def test_device_phases_leave_the_step_alone_and_read_none_on_cpu():
    rng = np.random.default_rng(1)
    batches = [{"data": {k: rng.integers(0, VOCAB, (2, SEQ)).astype(
        np.int32) for k in ("input", "target")}} for _ in range(3)]
    runs = []
    for read in (False, True):
        # the reading run under an obs session, as a card's would be
        with obs.session() if read else contextlib.nullcontext():
            tr = _tiny_lm_trainer()
            p, o = tr.init(0)
            metrics = []
            for step, batch in enumerate(batches):
                p, o, m = tr.train_step(p, o, batch, step)
                metrics.append({k: float(v) for k, v in m.items()})
                if read:
                    assert tr.timer.device_phases() is None
        runs.append((p, metrics))
    (pa, ma), (pb, mb) = runs
    assert ma == mb
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    x = torch.ones(3)
    assert step_graph.mark_grad(x, "head.grad") is x


def test_marks_become_phases_read_without_a_sync():
    timer = TimerInfo()
    at = {"step.start": 0.0, "head.start": 0.6, "head.end": 0.7,
          "step.forward": 0.72, "head.grad": 0.8, "step.backward": 1.9,
          "step.update": 2.0}

    class Event:
        def __init__(self, t, done=True):
            self.t, self.done = t, done

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    graph = step_graph.StepGraph("train_step", None,
                                 on_marks=timer.add_marks)

    def replayed(done):
        marks = [(k, Event(t, done)) for k, t in at.items()]
        graph._unread = step_graph._Captured(None, None, None, (), {},
                                             marks)
    replayed(False)
    graph.read_marks()                # not complete: skipped, not kept
    assert timer.device_phases() is None and graph._unread is None
    replayed(True)
    graph.read_marks()
    graph.read_marks()                # read once
    got = timer.device_phases()
    assert got.pop("samples") == 1
    assert got == pytest.approx({"step.forward": 0.72,
                                 "step.backward": 1.9 - 0.72,
                                 "step.update": 0.1,
                                 "step.head": 0.1 + 0.08})
    assert timer.to_string() == TimerInfo().to_string()
    reg = obs.MetricsRegistry()
    timer.register_into(reg)
    prom = obs.parse_prometheus(reg.render_prometheus())
    assert prom["singa_train_device_samples_total"] == 1
    assert prom["singa_train_device_step_update_seconds_total"] == \
        pytest.approx(0.1)


def test_program_mfu_comes_from_the_call_counters(monkeypatch):
    watch = perf.reset()
    monkeypatch.setattr(perf, "peak_flops", lambda: 1e6)
    perf.harvest("prog", flops=100.0)
    stats = ServeStats()
    perf.time_source(stats.program_calls)
    perf.time_source(stats.program_calls)     # counted once
    stats.observe_call("prog", 10.0, 10.5)
    stats.observe_call("prog", 20.0, 20.1)    # the last call alone: 0.1 s

    def mfu():
        return {s.labels: s.value for s in watch.collect()
                if s.name == "singa_program_mfu"}
    assert mfu() == {(("program", "prog"),): pytest.approx(
        100.0 * 2 / (0.6 * 1e6))}
    assert watch.snapshot()["cost"]["prog"] == pytest.approx(
        {"flops": 100.0, "calls": 2, "seconds": 0.6})
    del stats
    gc.collect()
    assert mfu() == {}                        # a dead owner drops out
    perf.reset()
