"""Train examples/mnist/conv.conf to 99% test accuracy on the card and
record the time to 99% (the metric BASELINE.md tracks).

Port of `singa_tpu/tools/convergence_run.py`.  The reference's
convergence configs train on real MNIST shards; with no MNIST at hand
the run uses the learnable synthetic source (`data.synthetic`): fixed
per-class templates, a held-out test stream (the same templates with
independent noise and labels, so the net must generalize), and a noise
level at which the net starts at chance.

Training runs through `Trainer.train_steps` in chunks, as CUDA-graph
replays on the card.  Two wall clocks are reported, as in the JAX
package: `time_to_99_seconds` from the start of `run()` (captures
included: what a user waits), and `train_time_to_99_seconds` over every
train chunk and evaluation after the train and eval graphs were
captured.  The result, with the card's name, is written to `out`
(build/CONVERGENCE.json by default, never the JAX package's file).

Usage: python -m singa_tpu_torch.tools.convergence_run [--target 0.99]
       [--max-steps 10000] [--out build/CONVERGENCE.json] [--noise-std 96]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _stack(batches):
    """One batch dict whose leaves carry a leading step axis."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches]) for k in first}
    return np.stack(batches)


def run(conf: str, target: float = 0.99, max_steps: int = 10000,
        out: str = os.path.join(REPO, "build", "CONVERGENCE.json"),
        noise_std: float = 96.0, chunk: int = 100, test_batches: int = 10,
        log=print, device: DeviceLike = None) -> dict:
    """Train `conf` on the synthetic source until the held-out accuracy
    (over `test_batches` batches of 1000) reaches `target` or
    `max_steps` pass, evaluating after every `chunk` steps; write and
    return the result dict.  Runs on the card unless `device` says
    otherwise."""
    t_start = time.time()
    from ..config import load_model_config
    from ..core.trainer import Trainer, _clone
    from ..data.synthetic import synthetic_image_batches
    from ..utils.profiler import hard_sync

    dev = resolve_device(device)
    cfg = load_model_config(conf)
    batch = next(l.data_param.batchsize for l in cfg.neuralnet.layer
                 if l.data_param)
    trainer = Trainer(cfg, {"data": {"pixel": (28, 28), "label": ()}},
                      log_fn=log, device=dev)
    params, opt_state = trainer.init(seed=0)

    train_iter = synthetic_image_batches(batch, seed=7, stream_seed=100,
                                         noise_std=noise_std)
    # held-out split: the same templates (seed), an independent stream
    test_iter = synthetic_image_batches(1000, seed=7, stream_seed=200,
                                        noise_std=noise_std)
    test_set = [next(test_iter) for _ in range(test_batches)]

    def test_accuracy(p):
        accs = [float(trainer.test_step(p, b)["precision"])
                for b in test_set]
        return float(np.mean(accs))

    step = 0
    train_s = 0.0
    result = None
    warm = [next(train_iter) for _ in range(chunk)]
    warm_stacked = _stack(warm)
    if trainer.graphs:
        # capture the train graph before timing starts, on copies: the
        # graphs adopt them, and the evaluation and the first chunk below
        # copy the run's params and state back in, so the trajectory is
        # unchanged
        trainer.train_step(_clone(params), _clone(opt_state), warm[0], 0)
        hard_sync()
    acc = acc0 = test_accuracy(params)   # also captures the eval graph
    log(f"step-0 test accuracy {acc0:.4f} (chance ~0.10)")
    while step < max_steps:
        n = min(chunk, max_steps - step)
        stacked = (warm_stacked if step == 0 and n == chunk
                   else _stack([next(train_iter) for _ in range(n)]))
        t0 = time.perf_counter()
        params, opt_state, _ = trainer.train_steps(
            params, opt_state, stacked, step, n, stacked=True)
        hard_sync(params)
        train_s += time.perf_counter() - t0
        step += n
        t0 = time.perf_counter()
        acc = test_accuracy(params)
        train_s += time.perf_counter() - t0
        log(f"step-{step} test accuracy {acc:.4f}")
        if acc >= target:
            result = {
                "mnist_test_accuracy": round(acc, 4),
                "steps_to_99": step,
                "time_to_99_seconds": round(time.time() - t_start, 2),
                "train_time_to_99_seconds": round(train_s, 2),
            }
            break
    final = {
        "conf": os.path.relpath(conf),
        "target": target,
        "data": f"synthetic-learnable(noise_std={noise_std}, "
                f"held-out stream)",
        "batchsize": batch,
        "test_samples": 1000 * test_batches,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "reached": result is not None,
        **(result or {"mnist_test_accuracy": round(acc, 4),
                      "steps_run": step}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(final, f, indent=1)
    log(json.dumps(final))
    return final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf",
                    default=os.path.join(REPO, "examples/mnist/conv.conf"))
    ap.add_argument("--target", type=float, default=0.99)
    ap.add_argument("--max-steps", type=int, default=10000)
    ap.add_argument("--out",
                    default=os.path.join(REPO, "build", "CONVERGENCE.json"))
    ap.add_argument("--noise-std", type=float, default=96.0)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--test-batches", type=int, default=10)
    a = ap.parse_args(argv)
    run(a.conf, a.target, a.max_steps, a.out, a.noise_std, a.chunk,
        a.test_batches)


if __name__ == "__main__":
    main()
