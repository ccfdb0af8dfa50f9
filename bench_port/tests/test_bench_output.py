"""The result line, the trace reduction, and the whole-name check that
the benchmark loads neither JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, cpu_run

from bench_port import harness


def test_result_line_keys_train_and_serve():
    for w, e2e in (("mistral7b_l4.train_s4096", "train_tokens_per_s"),
                   ("mistral7b_l4.serve_chat", "ttft_p95_ms")):
        rc, line = cpu_run(w)
        assert rc == 0
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        assert e2e in line["metrics"] and "setup_s" in line["metrics"]
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        json.dumps(line)


def test_forbidden_names_are_compared_whole():
    f = harness.forbidden_modules
    assert f(["singa_tpu_torch", "singa_tpu_torch.core.trainer",
              "numpy", "jax_like", "flaxen"]) == []
    assert f(["singa_tpu.core"]) == ["singa_tpu"]
    assert f(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _fresh(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_benchmark_modules_load_no_jax_and_reference_no_program():
    code = (
        "import sys, json; sys.path.insert(0, '.');"
        "import bench_port.reference.lm, bench_port.reference.vision, "
        "bench_port.reference.optim, bench_port.counts.flops;"
        "ref = sorted({n.split('.')[0] for n in sys.modules});"
        "import bench_port.harness as h, bench_port.drivers.train, "
        "bench_port.drivers.serve, bench_port.control, bench_port.sweep;"
        "[h.reader(m['name']) for m in h.benchmark()['per_layer']];"
        "import singa_tpu_torch;"
        "print(json.dumps([ref, h.forbidden_modules()]))")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    ref, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert "singa_tpu_torch" not in ref and "singa_tpu" not in ref
    assert found == []


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench::window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void k1<4>(int)", "ts": 10,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 60,
           "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 35,
           "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 45,
           "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 50}]
    s = harness.summarize(ev)
    assert abs(s["window_s"] - 100e-6) < 1e-12
    # busy: 10-40, 60-70, 95-100
    assert abs(s["busy_s"] - 45e-6) < 1e-12
    assert s["device_ops"][0][0] == "k1"
    assert abs(s["device_ops"][0][1] - 20e-6) < 1e-12
    gaps = dict(s["idle_gaps"])
    assert abs(gaps["aten::inner"] - 20e-6) < 1e-12       # 40-60, mid 50
    assert abs(gaps["host: no traced op"] - 35e-6) < 1e-12  # 0-10, 70-95


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    """No card here: exit 3 and no result.  In a directory holding only
    BENCHMARK.json and the benchmark's files it fails too."""
    def run(cwd):
        return subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload",
             "mistral7b_l4.train_s4096", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    import torch
    out = run(ROOT)
    if not torch.cuda.is_available():
        assert out.returncode == 3 and not out.stdout.strip()
    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(ROOT, "bench_port"), bare / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    out = run(bare)
    assert out.returncode != 0 and not out.stdout.strip()


def test_traced_runs_report_the_per_layer_metrics():
    """A `--trace 1` run (here on the CPU, where no device op runs) gives
    the traced span and the host-side per-layer metrics; device-only
    ones read nothing."""
    rc, line = cpu_run("mistral7b_l4.serve_chat", trace=1)
    assert rc == 0 and line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "breakdown" in line
    assert {"serve.queue_wait_p95_ms", "serve.slot_occupancy",
            "serve.tpot_p50_ms"} <= set(line["metrics"])
    rc, line = cpu_run("mistral7b_l4.train_s4096", trace=1)
    assert rc == 0 and line["correct"] and "breakdown" in line
