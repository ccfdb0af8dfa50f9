"""Trainer: SINGA's Worker (worker.cc) on one card.

Port of `singa_tpu/core/trainer.py` for one device: `Performance` and
`TimerInfo` (`:36-100`), and a `Trainer` with `init`, `train_step`
(forward, backward, update), `train_steps`, `evaluate`, `run` with the
reference's display / test / validation / checkpoint cadence, and
`resume`.  The JAX package compiles the whole step into one program; the
port runs it eagerly: autograd takes the gradients (through the flash
kernels', the fused head's and the LRN kernels' `autograd.Function`s)
and the updater works in place on the f32 master params under
`no_grad`.  Layers that draw (dropout, the RGB crop and mirror) seed
their generators from the trainer's `seed`, the step and their place in
the net, as `train_scan` folds the step and the layer index into its key
(`:396`), so a resumed run draws what an uninterrupted one draws.

Cadence semantics from ModelProto: train_steps, test_steps,
test_frequency/test_after_steps, validation_*, display_*,
checkpoint_frequency/checkpoint_after_steps; metrics averaged over the
display interval (worker.cc:350-386); per-phase wall time in the style
of TimerInfo (worker.h:91-114).

Not ported yet (ROADMAP.md): the overlapped feeder and scan chunks
(`compiled_scan`), elastic/async sync, pipeline nets, health probes,
fault sites, the SIGTERM/SIGINT checkpoint guard, contrastive-divergence
(RBM) training and `profile_phases`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..config.schema import ModelConfig
from ..device import DeviceLike, resolve_device
from ..utils.checkpoint import CheckpointManager
from ..weights import opt_state_from_numpy, params_from_numpy
from . import seq_layers  # noqa: F401  (registers the layer types)
from .layers import LAYER_REGISTRY
from .net import NeuralNet, build_net
from .updater import make_updater


@dataclass
class Performance:
    """Metric aggregation over an interval (worker.cc:350-386)."""
    totals: Dict[str, float] = field(default_factory=dict)
    counter: int = 0

    def update(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v)
        self.counter += 1

    def to_string(self) -> str:
        n = max(self.counter, 1)
        return ", ".join(f"{k} : {v / n:.6f}"
                         for k, v in sorted(self.totals.items()))

    def averages(self) -> Dict[str, float]:
        n = max(self.counter, 1)
        return {k: v / n for k, v in self.totals.items()}

    def reset(self) -> None:
        self.totals.clear()
        self.counter = 0


@dataclass
class TimerInfo:
    """Per-phase wall-time accumulator (worker.h:91-114): `wait` (the
    batch source) and `train` (the step, ending when its metrics reach
    the host)."""
    times: Dict[str, float] = field(default_factory=dict)
    steps: int = 0

    def add(self, phase: str, seconds: float) -> None:
        self.times[phase] = self.times.get(phase, 0.0) + seconds

    def to_string(self) -> str:
        total = sum(self.times.values()) or 1.0
        parts = [f"{k}: {v / max(self.steps, 1) * 1e3:.2f}ms "
                 f"({100 * v / total:.0f}%)"
                 for k, v in self.times.items()]
        return "Time per step — " + ", ".join(parts)

    def reset(self) -> None:
        self.times.clear()
        self.steps = 0


def _index(batch, i: int):
    """Step `i` of a stacked (nested) batch dict."""
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    return batch[i]


def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    else:
        yield batch


class Trainer:
    """Single-device training loop.  Runs on CUDA unless `device` says
    otherwise (see `singa_tpu_torch.device`)."""

    def __init__(self, model_cfg: ModelConfig,
                 input_shapes: Dict[str, Dict[str, tuple]],
                 log_fn: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None, seed: int = 0):
        """`seed` seeds the per-step generators of the layers that draw
        (see `Context.layer_rng`); params come from `init(seed)`."""
        self.cfg = model_cfg
        self.seed = seed
        self.log = log_fn if log_fn is not None \
            else (lambda msg: print(f"[trainer] {msg}", flush=True))
        self.device = resolve_device(device)
        self.compute_dtype = (torch.bfloat16
                              if model_cfg.precision == "bfloat16" else None)
        self.train_net = build_net(model_cfg, "kTrain", input_shapes)
        self.test_net = self._maybe_net("kTest", input_shapes)
        self.val_net = self._maybe_net("kValidation", input_shapes)
        self.updater = make_updater(model_cfg.updater)
        self.multipliers = self.train_net.multipliers()
        self.test_step = self._eval_step(self.test_net)
        self.val_step = self._eval_step(self.val_net)
        self.perf = Performance()
        self.timer = TimerInfo()
        for nm, freq, steps in (
                ("test", model_cfg.test_frequency, model_cfg.test_steps),
                ("validation", model_cfg.validation_frequency,
                 model_cfg.validation_steps)):
            if freq > 0 and steps <= 0:
                self.log(f"warning: {nm}_frequency is set but {nm}_steps "
                         f"is 0 — no {nm} net is built and {nm} "
                         f"evaluation will not run (worker.cc:16-27)")

    def _maybe_net(self, phase: str, input_shapes) -> Optional[NeuralNet]:
        """The eval net for `phase`, or None when the phase has no step
        count, data layer or loss layer (worker.cc:16-27); a configured
        phase that fails to build raises."""
        steps = (self.cfg.test_steps if phase == "kTest"
                 else self.cfg.validation_steps)
        if steps <= 0:
            return None
        cfgs = [l for l in self.cfg.neuralnet.layer
                if phase not in l.exclude]
        has = {attr: any(getattr(LAYER_REGISTRY.get(l.type), attr, False)
                         for l in cfgs)
               for attr in ("is_data", "is_loss")}
        if not (has["is_data"] and has["is_loss"]):
            return None
        return build_net(self.cfg, phase, input_shapes)

    def _eval_step(self, net: Optional[NeuralNet]):
        if net is None:
            return None

        def eval_step(params, batch):
            with torch.no_grad():
                _, metrics, _ = net.apply(params, batch, train=False,
                                          compute_dtype=self.compute_dtype,
                                          rng=self.seed)
            return metrics
        return eval_step

    # -- init --------------------------------------------------------------
    def init(self, seed: int = 0):
        params = self.train_net.init_params(seed, device=self.device)
        return params, self.updater.init(params)

    # -- steps -------------------------------------------------------------
    def gradients(self, params: Dict[str, torch.Tensor], batch,
                  step: int = 0) -> tuple:
        """(metrics, grads) of one forward and backward at `step`: `grads`
        maps every param to its gradient, or to None where none reached
        it."""
        names = sorted(params)
        leaves = [params[k] for k in names]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics, _ = self.train_net.apply(
                params, batch, train=True, compute_dtype=self.compute_dtype,
                rng=self.seed, step=step)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def train_step(self, params, opt_state, batch, step: int):
        """Forward, backward and update at `step`: params and opt_state
        are updated in place and returned with the step's metrics (device
        tensors).  Gradients come from `torch.autograd.grad`, so no
        `.grad` accumulates between steps; a param no gradient reaches
        gets zeros, as under `jax.value_and_grad`."""
        metrics, grads = self.gradients(params, batch, step)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in grads.items()}
        self.updater.update(step, grads, params, opt_state,
                            multipliers=self.multipliers)
        return params, opt_state, metrics

    def train_steps(self, params, opt_state, batches, start_step: int,
                    nsteps: int, stacked: bool = False):
        """`nsteps` steps from `start_step`, a Python loop over
        `train_step`: with `stacked`, every leaf of `batches` carries a
        leading `nsteps` axis (a fresh batch per step), else one batch is
        reused.  Returns stacked per-step metrics."""
        if stacked:
            bad = [tuple(x.shape) for x in _leaves(batches)
                   if x.ndim < 1 or x.shape[0] != nsteps]
            if bad:
                raise ValueError(f"stacked=True needs a leading {nsteps}-"
                                 f"axis on every batch leaf; got {bad}")
        ms = []
        for i in range(nsteps):
            batch = _index(batches, i) if stacked else batches
            params, opt_state, m = self.train_step(params, opt_state, batch,
                                                   start_step + i)
            ms.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in ms])
                                   for k in ms[0]}

    def evaluate(self, params, data_iter: Iterator, steps: int,
                 step_fn) -> Dict[str, float]:
        """Average metrics of `step_fn(params, batch)` over `steps`
        batches."""
        perf = Performance()
        for _ in range(max(steps, 1)):
            perf.update(step_fn(params, next(data_iter)))
        return perf.averages()

    # -- cadence helpers (worker.h:127-160 semantics) ----------------------
    def _now(self, step, freq, after) -> bool:
        return freq > 0 and step >= after and step % freq == 0

    def display_now(self, step):
        return self._now(step, self.cfg.display_frequency,
                         self.cfg.display_after_steps)

    def test_now(self, step):
        return self._now(step, self.cfg.test_frequency,
                         self.cfg.test_after_steps)

    def validate_now(self, step):
        return self._now(step, self.cfg.validation_frequency,
                         self.cfg.validation_after_steps)

    # -- the loop ----------------------------------------------------------
    def run(self, params, opt_state, train_iter: Iterator,
            test_iter_factory: Optional[Callable[[], Iterator]] = None,
            val_iter_factory: Optional[Callable[[], Iterator]] = None,
            start_step: int = 0,
            hooks: Optional[List[Callable[[int, Dict], None]]] = None,
            workspace: Optional[str] = None):
        """The Worker::Run loop (worker.cc:98-106), one step per
        iteration.  With `workspace` and checkpoint_frequency > 0, saves
        {params, opt_state, step} after each step s >=
        checkpoint_after_steps with (s+1) % checkpoint_frequency == 0,
        and at the end.  Returns (params, opt_state, history of test
        averages)."""
        cfg = self.cfg
        ckpt = (CheckpointManager(workspace, log_fn=self.log)
                if workspace and cfg.checkpoint_frequency > 0 else None)
        history: List[Dict[str, float]] = []
        saved = None
        for step in range(start_step, cfg.train_steps):
            if self.val_step and self.validate_now(step) \
                    and val_iter_factory:
                avg = self.evaluate(params, val_iter_factory(),
                                    cfg.validation_steps, self.val_step)
                self.log(f"step-{step} validation: " + ", ".join(
                    f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
            if self.test_step and self.test_now(step) and test_iter_factory:
                avg = self.evaluate(params, test_iter_factory(),
                                    cfg.test_steps, self.test_step)
                self.log(f"step-{step} test: " + ", ".join(
                    f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
                history.append({"step": step, **avg})
            t0 = time.perf_counter()
            batch = next(train_iter)
            t1 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            self.timer.add("wait", t1 - t0)
            self.timer.add("train", time.perf_counter() - t1)
            self.timer.steps += 1
            self.perf.update(metrics)
            for hook in hooks or ():
                self._call_hook(hook, step, metrics)
            if self.display_now(step):
                self.log(f"step-{step}: {self.perf.to_string()}")
                self.log(self.timer.to_string())
                self.perf.reset()
            if (ckpt is not None and step >= cfg.checkpoint_after_steps
                    and (step + 1) % cfg.checkpoint_frequency == 0):
                ckpt.save(step + 1, params, opt_state)
                saved = step + 1
        if (ckpt is not None and cfg.train_steps > start_step
                and saved != cfg.train_steps):
            ckpt.save(cfg.train_steps, params, opt_state)
        return params, opt_state, history

    def _call_hook(self, hook, step, metrics) -> None:
        """User hooks are observers, not training logic: one that raises
        is logged and training continues."""
        try:
            hook(step, metrics)
        except Exception as e:  # noqa: BLE001 — any user-hook failure
            name = getattr(hook, "__name__", repr(hook))
            self.log(f"warning: user hook {name} raised at step {step} "
                     f"({type(e).__name__}: {e}); continuing")

    def resume(self, params, opt_state, workspace: str):
        """Restore the latest restorable snapshot of `workspace`
        (Worker::Resume).  Returns (params, opt_state, start_step); the
        arguments come back unchanged with step 0 when there is none.  The
        snapshot's params and optimizer slots must match the net's and
        the updater's."""
        restored = CheckpointManager(workspace, log_fn=self.log).restore()
        if restored is None:
            return params, opt_state, 0
        rp, ro, step = restored
        if set(ro) != set(opt_state):
            raise ValueError(f"snapshot optimizer slots {sorted(ro)} != "
                             f"this updater's {sorted(opt_state)}")
        return (params_from_numpy(self.train_net, rp, device=self.device),
                opt_state_from_numpy(self.train_net, ro, device=self.device),
                step)
