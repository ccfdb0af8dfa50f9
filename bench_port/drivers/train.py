"""The training driver: `Trainer.train_steps` over a fixed pool of
batches made from the seed, for `--seconds`.

Set-up builds one `Trainer` (captured steps on the card), hands it the
weights the benchmark made from the seed, and drives it through its
first three steps with the window's own call (`train_steps` over the
stacked pool) on three different batches.  Those steps are the ones the
reference follows: each step's loss, the optimizer's history after the
first (from which the first gradient as the updater got it is read) and
the params after the third (copied to the host).  The window then runs
whole chunks of the pool until `--seconds` have passed, each chunk
closed by a synchronise; the rate is over every step and all the time
of the window.  A traced run profiles one chunk a third of the way in.

After the window: the peak memory is read, the program's draws of the
first steps are read back where the net draws (see `VisionTask`), the
program's state is freed, and the reference runs the same three steps
in float32 with TF32 off.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from .. import weights
from ..counts import flops
from ..models import (lm_model_config, lm_shapes, vision_model_config,
                      vision_shapes)
from ..reference import lm as ref_lm
from ..reference import optim, precision
from ..reference import vision as ref_vision

CHECK_STEPS = 3


class LMTask:
    """A token-stream LM cell: (batch, seq) of uniform random ids."""

    def __init__(self, cfg: Dict, cell: Dict, device, seed: int):
        self.cfg, self.cell = cfg, cell
        b, s = cell["batch"], cell["seq"]
        self.model = lm_model_config(cfg, b, s)
        self.shapes = lm_shapes(s)
        self.rows = ref_lm.param_shapes(cfg)
        self.multipliers = None
        self.per_step = b * s
        self.step_flops = flops.lm_train_flops(cfg, b, s)
        pool = weights.token_batches(seed, self.pool_size(), b, s,
                                     cfg["vocab_size"], device)
        self.pool = {"data": pool}

    def pool_size(self) -> int:
        return max(self.cell["chunk_steps"], CHECK_STEPS)

    def first(self, k: int) -> Dict:
        return {"data": {n: t[k] for n, t in self.pool["data"].items()}}

    def draws(self, trainer, steps) -> tuple:
        return [{} for _ in steps], []

    def reference(self, w, k: int, mode: str, draws: Dict):
        d = self.pool["data"]
        return ref_lm.loss_and_grads(self.cfg, w, d["input"][k],
                                     d["target"][k], mode,
                                     rows=self.cell.get("reference_rows", 1))


class VisionTask:
    """A SINGA vision cell: CIFAR-shaped images of byte values and labels.

    The net draws (kRGBImage's mirror coins, kDropout's masks) from the
    trainer's own generators, which a replay reads.  The reference
    cannot draw the same bits without the program, so it takes the
    program's draws of the checked steps, read back by running the
    drawing layers alone on the trainer's generators seeded for each
    step; that stage is checked by itself (`draws`)."""

    def __init__(self, cfg: Dict, cell: Dict, device, seed: int):
        self.cfg, self.cell = cfg, cell
        self.model = vision_model_config(cfg)
        self.batch = cfg["model"]["neuralnet"]["layer"][0]["data_param"][
            "batchsize"]
        self.shapes = vision_shapes(cfg)
        self.rows = ref_vision.param_shapes(cfg, self.batch)
        self.multipliers = ref_vision.multipliers(cfg)
        self.per_step = self.batch
        self.step_flops = flops.vision_train_flops(cfg, self.batch)
        pool = weights.image_batches(seed, self.pool_size(), self.batch,
                                     cfg["input"]["pixel"],
                                     cfg["input"]["classes"], device)
        self.pool = {"data": pool}

    pool_size = LMTask.pool_size
    first = LMTask.first

    def draws(self, trainer, steps) -> tuple:
        """(per step {"flips": (B,) bool, masks: {layer: (B, n) bool}},
        checks of the draws themselves as (name, value, limit))."""
        from singa_tpu_torch.core.layers import Context
        net = trainer.train_net
        layers = {l["name"]: l for l in self.cfg["model"]["neuralnet"]["layer"]}
        out, bad_parse, shares, kept = [], 0, [], {}
        for k in steps:
            trainer._seed_layers(k)
            data = self.first(k)["data"]
            got = {"masks": {}}
            for idx, name in net.drawing_layers().items():
                layer = net.layers[name]
                ctx = Context(batch=data, train=True,
                              compute_dtype=trainer.compute_dtype,
                              rng=trainer.seed, layer_index=idx, step=k,
                              device=trainer.device,
                              generators=trainer._gens)
                if layer.cfg.type == "kRGBImage":
                    y = layer.apply({}, [data], ctx)
                    scale = layers[name]["rgbimage_param"].get("scale", 1.0)
                    base = (data["pixel"].float().permute(0, 2, 3, 1)
                            * scale).to(y.dtype)
                    flip = (y == base.flip(2)).flatten(1).all(1)
                    same = (y == base).flatten(1).all(1)
                    bad_parse += int((~(flip | same)).sum())
                    got["flips"] = flip
                    shares.append(float(flip.float().mean()))
                else:
                    ones = torch.ones(net.layers[name].out_shape,
                                      dtype=trainer.compute_dtype,
                                      device=trainer.device)
                    y = layer.apply({}, [ones], ctx)
                    mask = y != 0
                    ratio = layers[name].get("dropout_param", {}).get(
                        "dropout_ratio",
                        self.cfg["unset_fields"]["dropout_ratio"])
                    inv = float(torch.tensor(1.0, dtype=y.dtype)
                                / torch.tensor(1 - ratio, dtype=y.dtype))
                    bad_parse += int(((y != 0) & (y != inv)).sum())
                    got["masks"][name] = mask
                    kept.setdefault(name, []).append(mask)
            out.append(got)
        checks = [("draws_unexplained", bad_parse, 0)]
        # The draws are the program's, so they are held to what the
        # configuration states by themselves: each share of coins or
        # kept units within 6 sigma of its rate, over each whole draw,
        # each image's row and each unit's column across the batch, and
        # no draw equal to another of any layer or step.
        worst = 0.0
        for s in shares:
            worst = max(worst, abs(s - 0.5) / math.sqrt(0.25 / self.batch))
        p = 1 - self.cfg["unset_fields"]["dropout_ratio"]
        every = [d["flips"] for d in out if "flips" in d]
        for masks in kept.values():
            for m in masks:
                m = m.flatten(1).float()
                for share, n in ((m.mean(), m.numel()),
                                 (m.mean(1), m.shape[1]),
                                 (m.mean(0), m.shape[0])):
                    z = (share - p).abs().max() / math.sqrt(p * (1 - p) / n)
                    worst = max(worst, float(z))
            every += masks
        repeats = sum(a.shape == b.shape and bool(torch.equal(a, b))
                      for i, a in enumerate(every) for b in every[i + 1:])
        checks += [("draws_rate_sigma", round(worst, 4), 6.0),
                   ("draws_repeated", repeats, 0)]
        return out, checks

    def reference(self, w, k: int, mode: str, draws: Dict):
        d = self.pool["data"]
        return ref_vision.loss_and_grads(self.cfg, w, d["pixel"][k],
                                         d["label"][k], mode,
                                         draws.get("flips"),
                                         draws.get("masks"))


TASKS = {"lm": LMTask, "vision": VisionTask}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    got = torch._foreach_norm([tensors[k].float() for k in names])
    return dict(zip(names, torch.stack(got).double().cpu().tolist()))


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keys=None) -> float:
    """Largest |prog - ref| of a leaf's norm, over the larger of that
    leaf's reference norm and the median leaf's."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def reference_readings(task, seed: int, device, mode: str, draws: List,
                       steps: int = CHECK_STEPS) -> Dict:
    """The reference's first steps in `mode` from the seed's weights:
    losses, the history's norms after step 0, the gradient norms of step
    0 and the params after `steps` steps (on the device)."""
    w = weights.make(task.rows, seed, device)
    upd = optim.Updater(task.cfg["train"].get("updater")
                        or task.cfg["model"]["updater"], task.multipliers)
    losses, hist, grad0 = [], None, None
    for k in range(steps):
        loss, grads = task.reference(w, k, mode, draws[k])
        upd.step(k, w, grads)
        if k == 0:
            hist, grad0 = _norms(upd.history), _norms(grads)
        losses.append(loss)
        del grads
    return {"losses": losses, "hist": hist, "grad0": grad0, "params": w}


def compare(prog: Dict, ref: Dict, p0: Dict[str, torch.Tensor]) -> Dict:
    """The three compared numbers: each checked step's loss, the first
    gradient as the updater got it (its history after one step) by the
    worst leaf, and the params' change after the checked steps by the
    worst leaf whose reference gradient is not nought to rounding."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
    dev = next(iter(p0.values())).device
    d_prog, d_ref = {}, {}
    for k in p0:       # leaf by leaf: one difference on the card at a time
        d_prog[k] = float((prog["params"][k].to(dev) - p0[k]).norm())
        d_ref[k] = float((ref["params"][k] - p0[k]).norm())
    med = statistics.median(ref["grad0"].values())
    moved = [k for k, g in ref["grad0"].items() if g >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": worst_gap(prog["hist"], ref["hist"]),
            "change_gap": worst_gap(d_prog, d_ref, moved),
            "leaves_compared": len(moved)}


def judge(nums: Dict, limits: Dict, extra=()) -> tuple:
    """(checks as (name, value, limit), correct): each compared number
    against the cell's limit, and `extra` checks beside them.  A number
    the cell file gives no limit is not compared (PERF.md names it with
    its readings)."""
    checks = [(k, nums[k], limits[k])
              for k in ("loss_gap", "grad_gap", "change_gap") if k in limits]
    checks += list(extra)
    return checks, all(math.isfinite(v) and v <= lim
                       for _, v, lim in checks)


def run(ctx) -> Dict:
    args, cfg, cell = ctx.args, ctx.config, ctx.cell
    device = torch.device(getattr(ctx, "device", "cuda"))
    from singa_tpu_torch import Trainer
    ctx.mark("port_import")
    task = TASKS[cfg["family"]](cfg, cell, device, args.seed)
    if device.type == "cuda":
        from singa_tpu_torch.ops import _kernels
        _kernels.build(cell["kernels"])
    ctx.mark("batches_and_kernel_build")
    tr = Trainer(task.model, task.shapes, device=device, seed=args.seed,
                 log_fn=lambda msg: None)
    specs = {k: tuple(s.shape) for k, s in tr.train_net.param_specs.items()}
    mine = {name: tuple(shape) for name, shape, _, _ in task.rows}
    if specs != mine:
        raise RuntimeError(f"the program's params {specs} are not the "
                           f"configuration's {mine}")
    ctx.mark("trainer")
    params = weights.make(task.rows, args.seed, device)
    opt = tr.updater.init(params)
    pool = task.pool
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    ctx.mark("weights")
    # the first steps, through the window's call and feed
    params, opt, m0 = tr.train_steps(params, opt, _rows(pool, 0, 1), 0, 1,
                                     stacked=True)
    hist = _norms(opt["history"])
    ctx.mark("capture_and_step_0")
    params, opt, m1 = tr.train_steps(params, opt,
                                     _rows(pool, 1, CHECK_STEPS), 1,
                                     CHECK_STEPS - 1, stacked=True)
    losses = [r["loss"] for r in tr.drain_metrics(m0) + tr.drain_metrics(m1)]
    ctx.mark("steps_1_2")
    t = time.perf_counter()
    kept = {k: v.to("cpu", copy=True) for k, v in params.items()}
    check_s = time.perf_counter() - t
    prog = {"losses": losses, "hist": hist, "params": kept}

    # the window: whole chunks of the pool, a synchronise after each
    n = task.pool_size()
    step, steps, traced, trace_s = CHECK_STEPS, 0, 0, 0.0
    sync()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0 - check_s
    while True:
        tracing = (ctx.trace is not None and not traced
                   and time.perf_counter() - t_open >= args.seconds / 3)
        if tracing:
            t_tr = time.perf_counter()
            ctx.trace.start()
        params, opt, m = tr.train_steps(params, opt, pool, step, n,
                                        stacked=True)
        sync()
        if tracing:
            ctx.trace.stop()
            trace_s, traced = time.perf_counter() - t_tr, n
        step += n
        steps += n
        if time.perf_counter() - t_open >= args.seconds:
            break
    window = time.perf_counter() - t_open
    if ctx.trace is not None:
        ctx.trace.finish()
    last = tr.drain_metrics(m)[-1]["loss"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    draws, draw_checks = task.draws(tr, range(CHECK_STEPS))
    del tr, params, opt, m, m0, m1
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, in float32 with TF32 off
    precision.strict_f32()
    ref = reference_readings(task, args.seed, device, "f32", draws)
    p0 = weights.make(task.rows, args.seed, device)
    nums = compare(prog, ref, p0)
    checks, correct = judge(nums, cell["limits"], draw_checks)
    checks.append(("last_loss_finite", int(math.isfinite(last)), 1))
    correct = correct and math.isfinite(last)
    rate = steps * task.per_step / window
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    rec = {"device_kind": kind, "cell": cell, "config": cfg, "window_s": window,
           "steps": steps, "per_step": task.per_step,
           "step_flops": task.step_flops,
           "untraced_s": window - trace_s, "untraced_steps": steps - traced,
           "trace": ctx.trace.summary if ctx.trace is not None else None,
           }
    if ctx.trace is not None:
        from ..harness import power_limit
        rec["power_limit"] = power_limit()
    return {"correct": correct, "attempted": steps, "failed": 0,
            "e2e": {cell["rate_metric"]: rate, "setup_s": setup_s},
            "rec": rec, "device": {"memory_peak_bytes": int(peak)},
            "checks": checks, "numbers": nums}


def _rows(pool: Dict, lo: int, hi: int) -> Dict:
    return {"data": {n: t[lo:hi] for n, t in pool["data"].items()}}
