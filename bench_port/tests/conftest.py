"""Shared pieces of the benchmark's own tests (run on the CPU:
`python -m pytest bench_port/tests -q`; the tests marked `port` that
need a card skip without one)."""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cfg, cell):
    """A configuration and cell at a size the CPU runs in seconds, with
    every other field as committed."""
    cfg, cell = copy.deepcopy(cfg), copy.deepcopy(cell)
    if cfg["family"] == "lm":
        cfg.update(hidden_size=64, num_attention_heads=4,
                   num_key_value_heads=2, intermediate_size=96,
                   vocab_size=320, num_hidden_layers=2)
        cfg["assumed"]["head_dim"] = 16
        cell.update(batch=2, seq=128, net_seq=256, reference_rows=1)
        if "spec" in cell:
            cell["spec"].update(cb_slots=4, cb_prompt_cap=128,
                                max_new_tokens=32)
            cell["load"].update(
                rate_rps=4.0,
                prompt={"median": 24, "sigma": 0.8, "lo": 8, "hi": 128},
                output={"median": 8, "sigma": 0.8, "lo": 2, "hi": 32})
            cell.update(check_tokens=40, warm_s=1.0, control_s=4.0,
                        trace_lead_s=0.5, trace_s=0.5)
    else:
        cfg["model"]["neuralnet"]["layer"][0]["data_param"]["batchsize"] = 16
        cell["chunk_steps"] = 4
    return cfg, cell


# limits at the shrunk size, where bfloat16 reads higher gaps than at the
# cells' widths (the cells' own limits are set from chip runs)
TINY_LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.05, "change_gap": 0.05,
               "served_gap": 0.1}


def cpu_run(workload, seconds=2.0, trace=0, bench=None, root=None,
            limits=None, seed=2 ** 31 + 5):
    """One run of a shrunk cell on the CPU through the harness, past its
    look for a card: (exit code, result line)."""
    import torch
    from bench_port import harness
    torch.set_num_threads(2)
    bench = bench or harness.benchmark()
    entry, cell, cfg = harness.cell_files(bench, workload,
                                          **({"root": root} if root else {}))
    cfg, cell = shrink(cfg, cell)
    cell["limits"].update({k: v for k, v in TINY_LIMITS.items()
                           if k in cell["limits"]})
    if limits:
        cell["limits"].update(limits)
    args = harness.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return harness.run_cell(bench, args, entry, cell, cfg,
                            time.perf_counter(),
                            {"platform": "cpu", "kind": "cpu", "count": 1},
                            device="cpu")


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
