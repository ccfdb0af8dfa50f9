"""Trainer: SINGA's Worker (worker.cc) on one card.

Port of `singa_tpu/core/trainer.py` for one device: `Performance` and
`TimerInfo` (`:36-100`), and a `Trainer` with `init`, `train_step`
(forward, backward, update), `train_steps`, `evaluate`, `run` with the
reference's display / test / validation / checkpoint cadence and its
chunked loop (`scan_chunk`, `_next_chunk_len`, the deferred metrics
drain), and `resume`.  Autograd takes the gradients (through the flash
kernels', the fused head's and the LRN kernels' `autograd.Function`s)
and the updater works in place on the f32 master params under
`no_grad`.

The JAX package compiles each step into one program (`_build_steps`,
`:338-472`).  On CUDA the port captures the train step (forward,
`torch.autograd.grad`, update) and the eval steps into CUDA graphs, one
per batch geometry (`core/step_graph.py`), and replays them; the step's
host values (the learning rate, Adam's bias corrections) are device
scalars the updater writes before each replay.  The CPU runs the same
code eagerly.  Layers that draw (dropout, the RGB crop and mirror) seed
their generators on the host from the trainer's `seed`, the step and
their place in the net, as `train_scan` folds the step and the layer
index into its key (`:396`), so a resumed run draws what an
uninterrupted one draws; a net with such a layer runs eagerly.

Cadence semantics from ModelProto: train_steps, test_steps,
test_frequency/test_after_steps, validation_*, display_*,
checkpoint_frequency/checkpoint_after_steps; metrics averaged over the
display interval (worker.cc:350-386); per-phase wall time in the style
of TimerInfo (worker.h:91-114).

Not ported yet (ROADMAP.md): the overlapped feeder, elastic/async sync,
pipeline nets, health probes, fault sites, the SIGTERM/SIGINT checkpoint
guard, contrastive-divergence (RBM) training and `profile_phases`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config.schema import ModelConfig
from ..device import DeviceLike, resolve_device
from ..utils.checkpoint import CheckpointManager
from ..weights import opt_state_from_numpy, params_from_numpy
from . import seq_layers  # noqa: F401  (registers the layer types)
from .layers import LAYER_REGISTRY
from .net import NeuralNet, _to_device, build_net
from .step_graph import StepGraph, leaves
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


def _stack(batches):
    """Host batches (nested dicts of numpy arrays or tensors) → one batch
    whose leaves carry a leading step axis."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(batches)
    return np.stack(batches)


class Trainer:
    """Single-device training loop.  Runs on CUDA unless `device` says
    otherwise (see `singa_tpu_torch.device`)."""

    def __init__(self, model_cfg: ModelConfig,
                 input_shapes: Dict[str, Dict[str, tuple]],
                 log_fn: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None, seed: int = 0,
                 graphs: Optional[bool] = None):
        """`seed` seeds the per-step generators of the layers that draw
        (see `Context.layer_rng`); params come from `init(seed)`.

        `graphs` picks how the steps run.  None: as CUDA-graph replays
        on CUDA when no layer of the train net draws, else eagerly (the
        log says why, once).  True: as replays, or raise (on the CPU, or
        for a net that draws).  False: eagerly.  The CPU always runs
        eagerly.  `self.graphs` holds the choice."""
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
        self.graphs = self._pick_graphs(graphs)
        # the params ("params") and optimizer state ("opt") that every
        # graph of this trainer was captured over
        self._state: Dict[str, Any] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._train_graph = (StepGraph("train_step", self._pool,
                                       writes=("params", "opt"))
                             if self.graphs else None)
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

    def _pick_graphs(self, graphs: Optional[bool]) -> bool:
        draws = [name for name, layer in self.train_net.layers.items()
                 if layer.draws]
        if draws and graphs is not False:
            why = (f"layers {draws} draw from generators that the host "
                   f"seeds per step and layer, which a CUDA graph would "
                   f"replay unchanged")
            if graphs:
                raise ValueError(f"graphs=True: {why}")
            self.log(f"the steps run eagerly: {why}")
            return False
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not "
                             f"{self.device}")
        return graphs is not False and self.device.type == "cuda"

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
        """`eval_step(params, batch)` → metrics (0-d tensors): the
        reference's `eval_step` (`:435-447`); under `graphs` a replay of
        the graph of the batch's geometry, whose metrics the next replay
        overwrites."""
        if net is None:
            return None
        # the trainer holds these closures: they must not hold it
        compute_dtype, seed, state = self.compute_dtype, self.seed, \
            self._state

        def forward(params, batch):
            with torch.no_grad():
                _, metrics, _ = net.apply(params, batch, train=False,
                                          compute_dtype=compute_dtype,
                                          rng=seed)
            return metrics
        if not self.graphs:
            return forward
        graph = StepGraph(f"eval_step[{net.phase}]", self._pool)

        def eval_step(params, batch):
            return graph(forward, _own(state, params)["params"], batch)
        return eval_step

    # -- init --------------------------------------------------------------
    def init(self, seed: int = 0):
        params = self.train_net.init_params(seed, device=self.device)
        return params, self.updater.init(params)

    # -- steps -------------------------------------------------------------
    def gradients(self, params: Dict[str, torch.Tensor], batch,
                  step: Optional[int] = 0) -> tuple:
        """(metrics, grads) of one forward and backward at `step`: `grads`
        maps every param to its gradient, or to None where none reached
        it."""
        names = sorted(params)
        tensors = [params[k] for k in names]
        for p in tensors:
            p.requires_grad_(True)
        try:
            loss, metrics, _ = self.train_net.apply(
                params, batch, train=True, compute_dtype=self.compute_dtype,
                rng=self.seed, step=step)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        finally:
            for p in tensors:
                p.requires_grad_(False)
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def _step(self, params, opt_state, batch, step: Optional[int]):
        """Forward, backward and the update of the step last written by
        `Updater.set_step`: the device work of one train step, eager or
        captured."""
        metrics, grads = self.gradients(params, batch, step)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in grads.items()}
        self.updater.apply(grads, params, opt_state,
                           multipliers=self.multipliers)
        return metrics

    def _train_body(self, state, batch):
        # no layer draws under graphs, so the step number is not needed
        return self._step(state["params"], state["opt"], batch, None)

    def train_step(self, params, opt_state, batch, step: int):
        """Forward, backward and update at `step`: params and opt_state
        are updated in place and returned with the step's metrics (0-d
        device tensors).  Gradients come from `torch.autograd.grad`, so
        no `.grad` accumulates between steps; a param no gradient
        reaches gets zeros, as under `jax.value_and_grad`.

        Under `graphs` the step is a replay of the graph of the batch's
        geometry (captured at its first sight), and the graphs own their
        params and state: a call with the graphs' own tensors updates them
        in place; a call with others (after `resume` or
        `params_from_numpy`, say) copies them in first.  Either way the
        call returns the graphs' dicts, and the metrics are the graph's
        outputs, which the next replay overwrites."""
        if not self.graphs:
            self.updater.set_step(step, params, self.multipliers)
            return params, opt_state, self._step(params, opt_state, batch,
                                                 step)
        state = _own(self._state, params, opt_state)
        self.updater.set_step(step, state["params"], self.multipliers)
        metrics = self._train_graph(self._train_body,
                                    {"params": state["params"],
                                     "opt": state["opt"]}, batch)
        return state["params"], state["opt"], metrics

    def train_steps(self, params, opt_state, batches, start_step: int,
                    nsteps: int, stacked: bool = False):
        """`nsteps` steps from `start_step` with no host sync between
        them, the reference's `lax.scan` (`:376-433`): with `stacked`,
        every leaf of `batches` carries a leading `nsteps` axis (a fresh
        batch per step), else one batch is reused.  Each step's metrics
        are copied into an (nsteps,) slot per key on the device before
        the next step can overwrite them; returns (params, opt_state,
        those stacked metrics)."""
        if stacked:
            bad = [tuple(x.shape) for x in leaves(batches)
                   if x.ndim < 1 or x.shape[0] != nsteps]
            if bad:
                raise ValueError(f"stacked=True needs a leading {nsteps}-"
                                 f"axis on every batch leaf; got {bad}")
        out = None
        for i in range(nsteps):
            batch = _index(batches, i) if stacked else batches
            params, opt_state, m = self.train_step(params, opt_state, batch,
                                                   start_step + i)
            if out is None:
                out = {k: v.new_empty((nsteps,) + tuple(v.shape))
                       for k, v in m.items()}
            for k, v in m.items():
                out[k][i].copy_(v)
        return params, opt_state, out

    def drain_metrics(self, stacked: Dict[str, torch.Tensor]
                      ) -> List[Dict[str, float]]:
        """Per-step metrics from (n,)-stacked device tensors: one transfer
        to the host, the one sync a deferred drain pays (the reference's
        `_drain_chunks`, `:815-870`), then a dict of floats per step, in
        step order."""
        keys = list(stacked)
        host = torch.stack([stacked[k].double() for k in keys]).cpu().numpy()
        return [{k: float(host[j, i]) for j, k in enumerate(keys)}
                for i in range(host.shape[1])]

    def evaluate(self, params, data_iter: Iterator, steps: int,
                 step_fn) -> Dict[str, float]:
        """Average metrics of `step_fn(params, batch)` (0-d tensors) over
        `steps` batches.  Each batch's metrics are copied into a slot on
        the device, and all of them reach the host in one transfer at the
        end (`drain_metrics`); they are then summed in batch order, as
        `Performance.update` sums them."""
        steps = max(steps, 1)
        slots = None
        for i in range(steps):
            m = step_fn(params, next(data_iter))
            if slots is None:
                slots = {k: v.new_empty((steps,) + tuple(v.shape))
                         for k, v in m.items()}
            for k, v in m.items():
                slots[k][i].copy_(v)
        perf = Performance()
        for m in self.drain_metrics(slots):
            perf.update(m)
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

    def _next_chunk_len(self, step: int, scan_chunk: int) -> int:
        """Longest chunk [step, step+n) that crosses no test/validate/
        checkpoint boundary (those run on the host between chunks);
        display steps may fall inside a chunk because their metrics come
        back stacked.  The reference's `_next_chunk_len` (`:693-733`)
        without the elastic tier."""
        n = min(scan_chunk, self.cfg.train_steps - step)

        def next_event(freq, after):
            # smallest multiple of freq that is > step and >= after
            if freq <= 0:
                return None
            m = (step // freq + 1) * freq
            if m < after:
                m = -(-after // freq) * freq
            return m

        for freq, after in ((self.cfg.test_frequency,
                             self.cfg.test_after_steps),
                            (self.cfg.validation_frequency,
                             self.cfg.validation_after_steps)):
            e = next_event(freq, after)
            if e is not None:
                n = min(n, e - step)
        f = self.cfg.checkpoint_frequency
        if f > 0:
            # saves fire after steps s with (s+1) % f == 0; a chunk may
            # end on such a step but not run past it
            s_ck = ((step + 1 + f - 1) // f) * f - 1
            n = min(n, s_ck - step + 1)
        return max(n, 1)

    # -- the loop ----------------------------------------------------------
    def run(self, params, opt_state, train_iter: Iterator,
            test_iter_factory: Optional[Callable[[], Iterator]] = None,
            val_iter_factory: Optional[Callable[[], Iterator]] = None,
            start_step: int = 0,
            hooks: Optional[List[Callable[[int, Dict], None]]] = None,
            workspace: Optional[str] = None, scan_chunk: int = 0):
        """The Worker::Run loop (worker.cc:98-106).  With `workspace` and
        checkpoint_frequency > 0, saves {params, opt_state, step} after
        each step s >= checkpoint_after_steps with (s+1) %
        checkpoint_frequency == 0, and at the end.  Returns (params,
        opt_state, history of test averages).

        `scan_chunk > 1` runs chunks of up to that many steps through
        `train_steps`, cut at every test, validation and checkpoint
        boundary (`_next_chunk_len`); a chunk's metrics stay on the
        device until it ends, then one fetch drains them and the hooks,
        `Performance` and the display lines run per step, in step order.
        `scan_chunk` 0 (or 1) runs one step and one fetch per
        iteration.  The TimerInfo "train" phase takes the steps and the
        drain's wait, as in the reference (`:824-826`)."""
        cfg = self.cfg
        ckpt = (CheckpointManager(workspace, log_fn=self.log)
                if workspace and cfg.checkpoint_frequency > 0 else None)
        history: List[Dict[str, float]] = []
        saved = None
        chunked = scan_chunk > 1
        step = start_step
        while step < cfg.train_steps:
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
            n = self._next_chunk_len(step, scan_chunk) if chunked else 1
            t0 = time.perf_counter()
            batches = [next(train_iter) for _ in range(n)]
            t1 = time.perf_counter()
            if chunked:
                params, opt_state, stacked = self.train_steps(
                    params, opt_state,
                    _to_device(_stack(batches), self.device), step, n,
                    stacked=True)
            else:
                params, opt_state, m = self.train_step(
                    params, opt_state, batches[0], step)
                stacked = {k: v.reshape(1) for k, v in m.items()}
            per_step = self.drain_metrics(stacked)
            self.timer.add("wait", t1 - t0)
            self.timer.add("train", time.perf_counter() - t1)
            self.timer.steps += n
            for s, metrics in enumerate(per_step, start=step):
                self.perf.update(metrics)
                for hook in hooks or ():
                    self._call_hook(hook, s, metrics)
                if self.display_now(s):
                    self.log(f"step-{s}: {self.perf.to_string()}")
                    self.log(self.timer.to_string())
                    self.perf.reset()
            last = step + n - 1
            if (ckpt is not None and last >= cfg.checkpoint_after_steps
                    and (last + 1) % cfg.checkpoint_frequency == 0):
                ckpt.save(last + 1, params, opt_state)
                saved = last + 1
            step += n
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


def _own(state: Dict[str, Any], params, opt_state=None) -> Dict[str, Any]:
    """`state` holds the params and optimizer state a trainer's graphs
    run over: the first ones given are adopted; tensors given later that
    are not those are copied into them."""
    for key, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        mine = state.get(key)
        if mine is None:
            state[key] = tree
        elif tree is not mine:
            _copy_into(mine, tree, key)
    return state


def _copy_into(mine, tree, what: str) -> None:
    """Copy the tensors of `tree` into `mine`, which has the same keys."""
    if set(mine) != set(tree):
        raise ValueError(f"{what}: keys {sorted(tree)} are not the "
                         f"graphs' {sorted(mine)}")
    for k, t in tree.items():
        if isinstance(t, dict):
            _copy_into(mine[k], t, f"{what}/{k}")
        elif t is not mine[k]:
            mine[k].copy_(t)
