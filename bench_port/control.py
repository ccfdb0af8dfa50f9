"""The controls of `correct`: readings that the limits are set between.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \
        [--mode fp8|half] [--device cuda]

For a training cell it runs the plain reference twice per seed, in the
program's place in `--mode` and as the reference in float32, and prints
the numbers the cell compares (`drivers.train.compare`), one JSON line
a seed.  `fp8` is the control: the reference in the nearest precision
below the configurations' bfloat16 (`reference.precision`).  `half` is
a planted fault: the program's place takes the mean over the first
half of each batch only.  Draws (mirror coins, dropout masks) are made
from the seed, the same for both sides.

For a serving cell it serves nothing: at every position of prompts and
continuations made from the seed it reads, against the float32
reference's logits, how far below the best logit the token lies that
`--mode` puts first (`drivers.serve.control_readings`), the widest gap per
seed.  A lower reading comes from the benchmark's own runs.

Each line also holds the numbers against the cell file's limits as a
run judges them (`drivers.train.judge`; `served_gap` for serving) and
the `correct` that a run reading them would report.  In `fp8` and
`half` every seed has to come out not correct: the exit code is 1 where
one does not.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def train_readings(cfg, cell, seed, device, mode):
    import torch
    from bench_port import weights
    from bench_port.drivers import train
    from bench_port.reference import precision
    precision.strict_f32()
    task = train.TASKS[cfg["family"]](cfg, cell, device, seed)
    draws = [{} for _ in range(train.CHECK_STEPS)]
    if cfg["family"] == "vision":
        from bench_port.counts.flops import vision_shapes
        g = weights.generator(seed, 0x5EED0003, device)
        drop = [r for r in vision_shapes(cfg, task.batch)
                if r["type"] == "kDropout"]
        for d in draws:
            d["flips"] = torch.rand(task.batch, generator=g,
                                    device=device) < 0.5
            d["masks"] = {r["name"]: torch.rand(r["shape"], generator=g,
                                                device=device) < 0.5
                          for r in drop}
    if mode == "half":
        whole = task.reference

        def half(w, k, m, dr, whole=whole):
            data = task.pool["data"]
            saved = dict(data)
            n = next(iter(data.values())).shape[1] // 2
            for key in data:
                data[key] = data[key][:, :n]
            sub = dict(dr)
            if "flips" in dr:
                sub = {"flips": dr["flips"][:n],
                       "masks": {k2: v[:n] for k2, v in dr["masks"].items()}}
            try:
                return whole(w, k, "f32", sub)
            finally:
                data.update(saved)
        task.reference = half
        mode = "f32"
    prog = train.reference_readings(task, seed, device, mode, draws)
    prog["params"] = {k: v.cpu() for k, v in prog["params"].items()}
    task.__dict__.pop("reference", None)
    ref = train.reference_readings(task, seed, device, "f32", draws)
    p0 = weights.make(task.rows, seed, device)
    return train.compare(prog, ref, p0)


def readings(cfg, cell, seed, device, mode):
    """(numbers, checks, correct) of one seed in `mode`."""
    if cell["driver"] == "train":
        from bench_port.drivers import train
        nums = train_readings(cfg, cell, seed, device, mode)
        checks, correct = train.judge(nums, cell["limits"])
        return nums, checks, correct
    from bench_port.drivers import serve
    nums = serve.control_readings(cfg, cell, seed, device, mode)
    gap, lim = nums["control_gap"], cell["limits"]["served_gap"]
    return nums, [("served_gap", gap, lim)], math.isfinite(gap) and gap <= lim


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="fp8", choices=("fp8", "half", "bf16"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench_port import harness
    bench = harness.benchmark()
    entry, cell, cfg = harness.cell_files(bench, args.workload)
    passed = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        nums, checks, correct = readings(cfg, cell, seed, args.device,
                                         args.mode)
        passed += [seed] if correct else []
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **nums, "correct": correct,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks},
                          "seconds": time.perf_counter() - t}), flush=True)
    if args.mode != "bf16" and passed:
        print(f"the {args.mode} control came out correct on seeds {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
