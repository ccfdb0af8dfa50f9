"""`correct` against faults planted under a run, and the control, at a
size the CPU holds.  Each fault drives the rest of a run past the
harness's look for a card and must turn `correct` false.  (No cell
spans chips, so there is no exchange to leave out.)"""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT, TINY_LIMITS, cpu_run, shrink

TRAIN = ("mistral7b_l4.train_s4096", "alexnet_cifar10.train_b1024")


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_run_is_correct(workload):
    rc, line = cpu_run(workload)
    assert rc == 0 and line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    from singa_tpu_torch.core import updater
    monkeypatch.setattr(updater.Updater, "apply",
                        lambda self, *a, **k: None)
    rc, line = cpu_run(workload)
    assert rc == 0 and not line["correct"]
    assert line["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    from singa_tpu_torch.core.trainer import Trainer
    grads = Trainer._grads

    def half(self, params, batch, step):
        data = {k: v[:v.shape[0] // 2] for k, v in batch["data"].items()}
        return grads(self, params, {"data": data}, step)
    monkeypatch.setattr(Trainer, "_grads", half)
    rc, line = cpu_run(workload)
    assert rc == 0 and not line["correct"]


def test_token_altered_where_produced(monkeypatch):
    from singa_tpu_torch.serve.engine import InferenceEngine
    decode = InferenceEngine.run_cb_decode

    def altered(self, *a, **k):
        toks, pools = decode(self, *a, **k)
        return (toks + 1) % 320, pools
    monkeypatch.setattr(InferenceEngine, "run_cb_decode", altered)
    rc, line = cpu_run("mistral7b_l4.serve_chat")
    assert rc == 0 and not line["correct"]
    assert line["checks"]["served_gap"]["value"] > 0.1


def _files(workload):
    from bench_port import harness
    _, cell, cfg = harness.cell_files(harness.benchmark(), workload)
    return shrink(cfg, cell)


@pytest.mark.parametrize("workload", TRAIN)
def test_control_reads_above_the_program_precision(workload):
    """The reference in fp8 in the program's place reads at least three
    times what the reference in bf16 (the configurations' precision)
    reads, on one number or more."""
    import torch
    from bench_port.control import train_readings
    torch.set_num_threads(2)
    cfg, cell = _files(workload)
    low = train_readings(cfg, cell, 3, "cpu", "bf16")
    high = train_readings(cfg, cell, 3, "cpu", "fp8")
    assert any(high[k] >= 3 * low[k]
               for k in ("loss_gap", "grad_gap", "change_gap")), (low, high)


def test_serving_control_reads_above_the_program_precision():
    from bench_port.drivers import serve
    cfg, cell = _files("mistral7b_l4.serve_chat")
    low = serve.control_readings(cfg, cell, 3, "cpu", "bf16")
    high = serve.control_readings(cfg, cell, 3, "cpu", "fp8")
    assert high["control_gap"] > 3 * low["control_gap"]


@pytest.mark.parametrize("mode,correct", (("half", False), ("bf16", True)))
def test_control_is_judged_by_the_cell_limits(mode, correct, monkeypatch,
                                              capsys):
    """`control.py` holds each seed's numbers against the cell file's
    limits as a run does, and exits 1 where a control comes out
    correct."""
    from bench_port import control, harness
    files = harness.cell_files

    def shrunk(bench, workload, **kw):
        entry, cell, cfg = files(bench, workload, **kw)
        cfg, cell = shrink(cfg, cell)
        cell["limits"].update({k: v for k, v in TINY_LIMITS.items()
                               if k in cell["limits"]})
        return entry, cell, cfg
    monkeypatch.setattr(harness, "cell_files", shrunk)
    rc = control.main(["--workload", "mistral7b_l4.train_s4096",
                       "--seeds", "3", "--mode", mode, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert set(line["checks"]) == {"grad_gap", "change_gap"}
    assert rc == 0
    if mode == "half":
        monkeypatch.setitem(TINY_LIMITS, "grad_gap", 10.0)
        monkeypatch.setitem(TINY_LIMITS, "change_gap", 10.0)
        assert control.main(["--workload", "mistral7b_l4.train_s4096",
                             "--seeds", "3", "--mode", mode,
                             "--device", "cpu"]) == 1


def test_controls_fail_the_cell_limits_on_the_card(card):
    """Each cell's control (and, for a training cell, half of each batch
    left out) at the cell's own size on three seeds, every seed judged
    not correct by the committed limits."""
    import subprocess
    import sys
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for w in cells:
        _, cell, _ = _files(w)
        for mode in ("fp8", "half") if cell["driver"] == "train" else ("fp8",):
            out = subprocess.run(
                [sys.executable, "bench_port/control.py", "--workload", w,
                 "--seeds", "2147484901,2147484902,2147484903",
                 "--mode", mode], cwd=ROOT, capture_output=True, text=True,
                timeout=1200)
            assert out.returncode == 0, (w, mode, out.stderr[-2000:])
            lines = [json.loads(x) for x in out.stdout.splitlines()]
            assert len(lines) == 3 and not any(x["correct"] for x in lines)


def test_whole_cell_runs_on_the_card(card):
    """Each cell once through `run.py` on the card, its result correct."""
    import subprocess
    import sys
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for w in cells:
        out = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload", w,
             "--seed", "2147483999", "--seconds", "5", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
