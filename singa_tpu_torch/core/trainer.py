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
code eagerly.  Layers that draw (dropout, the RGB crop and mirror, the
MNIST distortion) draw from generators the trainer owns, one per layer
on the params' device, registered with the train graphs and seeded
before every step, eager or replayed, from the trainer's `seed`, the
step and the layer's place in the net, as `train_scan` folds the step
and the layer index into its key (`:396`); so a replay draws what an
eager step draws, and a resumed run what an uninterrupted one draws.
What a step decides on the host (the MNIST distortion's `elastic_freq`)
keys its graph, where the JAX package branches with `lax.cond`.

`alg: kContrastiveDivergence` nets train through `run_cd` (greedy CD-k
over the kRBM layers, `:1125-1247`), one captured step per RBM on CUDA;
over a process mesh each rank runs the chain on its rows with its rows
of the global batch's uniforms, over a model axis with its RBM's params
gathered at use, and averages the gradients over the data × seq ranks.

Cadence semantics from ModelProto: train_steps, test_steps,
test_frequency/test_after_steps, validation_*, display_*,
checkpoint_frequency/checkpoint_after_steps; metrics averaged over the
display interval (worker.cc:350-386); per-phase wall time in the style
of TimerInfo (worker.h:91-114).

The robustness tier of the JAX trainer is here too: with a
`HealthMonitor` (`health=`) the train step computes the health probes
on the device (`utils/health.py`), eager or captured, and they drain
with the chunk's metrics; a fatal verdict raises `NumericDivergence`
before a hook or a save sees the step, and saves carry the window's
verdict (a fatal window's save is refused).  The `step.train` site is
visited once per loop iteration and `step.grad` once per step; a step
whose gradients a `step.grad` fault poisons runs eagerly on the graphs'
own tensors, so the captured graphs never branch.  While a workspace
is checkpointed, SIGTERM/SIGINT save at the current step and return.
`run(scan_chunk=k)` stages chunks through `data.feed` (a `DeviceFeeder`
thread by default).

How the trainer measures itself (`:62-99`, `:474-556`, `:853-972`):
the train and eval steps harvest their analytic FLOPs into CostWatch
(`obs.perf`, `utils/flops.py`) at first use, so /metrics carries
`singa_program_flops` and, with `TimerInfo`'s `train` seconds and steps
(`obs.perf.time_source`), `singa_program_mfu`.  A train step captured
while an `obs` session is active records device marks at its phase
boundaries (`step.start`,
`step.forward`, `step.backward`, `step.update`, and the LM head's
`head.start`, `head.end`, `head.grad`), event-record nodes that every
replay records anew; a replay whose marks are read before the next adds
its `step.forward`, `step.backward`, `step.update` and `step.head`
device seconds to `TimerInfo` (`device_phases`), with no synchronise.
`train_step` opens the host spans `trainer.step_prepare` (`_own`,
`set_step`, the capture at a geometry's first step, `_seed_layers`)
and `trainer.replay`.  `profile_phases` traces one eager step on clones
of the state and pins its device fwd/bwd/update split on `TimerInfo`
(`run` calls it at the first display step under `phase_profile` or
SINGA_TPU_PHASE_PROFILE=1); with `ModelProto.debug`, `run` logs
`NeuralNet.debug_info` of an eager forward and backward at each display
step.  Neither moves the params, the optimizer state, the generators or
the data stream.

The async consistency tier (`:179-182`, `:711-719`, `:780-787`,
`:973-976`): when the updater asks for Elastic or RandomSync
(`parallel.elastic.async_active`), `run` exchanges the params with a
center copy (`self.elastic`, an `ElasticController`) after each sync
step, in place on the tensors the graphs own, and chunks end on sync
steps.  The center is not checkpointed: it seeds lazily from the first
post-warmup params of the process, so a resumed run seeds it anew.
Several replica groups train through `parallel.elastic.ReplicaSet`.

Training over a process mesh (`dp=`, a `parallel.partition.
DataParallel`): every rank is handed the same global batch and trains
on its slice of dim 0 (and for a sequence-parallel net its chunk of
dim 1; drawing layers keep their part of the global draw).  Over a
model axis the params and optimizer state are the rank's shards
(`init` and `resume` shard them) and the layers run their collectives
over the axis; the gradients and the step's metrics are averaged over
the data × seq ranks through gloo before the update, so every rank of
a model shard applies the same update.  A gloo collective cannot be
captured, so such a trainer's steps run eagerly, the evaluation's too;
evaluation runs the whole global batch on every rank (its seq chunk
under sequence parallelism), and only rank 0 writes checkpoints, whole
and spec-shaped (`_ckpt_state` gathers them over the model axis).

Pipeline nets (`:209-242`): when the config marks stages with
`locationid` and the mesh has a pipe axis above 1, the train, test and
validation steps run through `parallel.pipeline_net.PipelineNet` (or
`HeteroPipelineNet` for stages of different structure) with `n_micro`
microbatches (2·pipe by default, `ClusterProto.pipeline_microbatches`);
a uniform pipeline's stage params live on their pipe rank only, and the
gradient of every param whole on every pipe rank is summed over the
pipe axis before the data mean.  Beside a model, seq or expert axis a
stage runs without the mesh, its params whole on those ranks, as the
JAX stage does; the pre and post groups run over the whole mesh.  Over
an expert axis kMoE holds its rank's experts, and under a data or seq
axis it routes the global tokens (`ops/moe.py`); inside a stage it
routes the cell's tokens and its aux loss is dropped, as in the JAX
package.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from .. import obs
from ..config.schema import ModelConfig
from ..device import DeviceLike, resolve_device
from ..obs import perf
from ..utils import faults, profiler
from ..utils.checkpoint import CheckpointManager
from ..utils.flops import net_forward_flops, net_train_flops
from ..weights import opt_state_from_numpy, params_from_numpy
from . import seq_layers  # noqa: F401  (registers the layer types)
from .layers import LAYER_REGISTRY, fold_in, layer_seed
from .net import NeuralNet, build_net
from .step_graph import StepGraph, leaves, mark
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


#: the device phases of a replayed train step, from its marks (name:
#: (start mark, end mark)); `step.head` adds the head's backward
#: (`step.forward` to `head.grad`) to its forward
DEVICE_PHASES = {"step.forward": ("step.start", "step.forward"),
                 "step.backward": ("step.forward", "step.backward"),
                 "step.update": ("step.backward", "step.update"),
                 "step.head": ("head.start", "head.end")}


@dataclass
class TimerInfo:
    """Per-phase wall-time accumulator (worker.h:91-114): `wait` (the
    batch source, or the feeder), `stage` (stacking and issuing a
    chunk's copy; the feeder's thread does it off the critical path) and
    `train` (the steps, and the drain's wait for their metrics).  The
    device's fwd/bwd/update split, which the reference timed around each
    phase call, comes from a one-shot trace of an eager step
    (`Trainer.profile_phases`) and rides along as `phase_shares`.

    Beside them, the device seconds of each phase of the replayed train
    step (`DEVICE_PHASES`), summed over the replays whose marks were
    read (`add_marks`, `device_samples` of them; `core/step_graph.py`)
    and read through `device_phases`.  They are counters: `reset` keeps
    them."""
    times: Dict[str, float] = field(default_factory=dict)
    steps: int = 0
    phase_shares: Optional[Dict[str, float]] = None
    device: Dict[str, float] = field(default_factory=dict)
    device_samples: int = 0

    def add(self, phase: str, seconds: float) -> None:
        self.times[phase] = self.times.get(phase, 0.0) + seconds

    def add_marks(self, at: Dict[str, float]) -> None:
        """Add one replay's phases from its marks (seconds since the
        first): a phase whose marks the step did not record is left
        out."""
        for phase, (a, b) in DEVICE_PHASES.items():
            if a in at and b in at:
                secs = at[b] - at[a]
                if phase == "step.head":
                    if "head.grad" not in at:
                        continue
                    secs += at["head.grad"] - at["step.forward"]
                self.device[phase] = self.device.get(phase, 0.0) + secs
        self.device_samples += 1

    def device_phases(self) -> Optional[Dict[str, float]]:
        """{"samples": n, phase: device seconds summed over n replays},
        or None before any replay was read (eager steps, the CPU, a
        graph captured without an `obs` session)."""
        if not self.device_samples:
            return None
        return {"samples": self.device_samples, **self.device}

    def program_seconds(self) -> Dict[str, tuple]:
        """{"train_step": (steps, seconds)} of the `train` phase, for
        CostWatch's MFU (`obs.perf.time_source`)."""
        return {"train_step": (self.steps, self.times.get("train", 0.0))}

    def to_string(self) -> str:
        total = sum(self.times.values()) or 1.0
        parts = [f"{k}: {v / max(self.steps, 1) * 1e3:.2f}ms "
                 f"({100 * v / total:.0f}%)"
                 for k, v in self.times.items()]
        out = "Time per step — " + ", ".join(parts)
        if self.phase_shares:
            shares = dict(self.phase_shares)
            cov = shares.pop("coverage", None)
            out += " [device: " + ", ".join(
                f"{k} {100 * v:.0f}%" for k, v in shares.items())
            if cov is not None:
                # work outside every phase is left out of the shares
                out += f" — {100 * cov:.0f}% of device time attributed"
            out += "]"
        return out

    def reset(self) -> None:
        self.times.clear()
        self.steps = 0

    def register_into(self, registry,
                      prefix: str = "singa_train") -> None:
        """Register the phase totals into an `obs.MetricsRegistry` as a
        pull-time collector: `<prefix>_steps_total` and
        `<prefix>_phase_<phase>_seconds_total`, the JAX package's
        series; and, once a replay's marks were read,
        `<prefix>_device_samples_total` and
        `<prefix>_device_<phase>_seconds_total` (`step_forward`, ...)."""
        from ..obs.metrics import Sample

        def collect():
            out = [Sample(f"{prefix}_steps_total", "counter",
                          "training steps timed", float(self.steps))]
            for phase, secs in sorted(self.times.items()):
                out.append(Sample(
                    f"{prefix}_phase_{phase}_seconds_total", "counter",
                    f"cumulative host seconds in the {phase!r} phase",
                    secs))
            if self.device_samples:
                out.append(Sample(f"{prefix}_device_samples_total",
                                  "counter", "replays whose device phases "
                                  "were read", float(self.device_samples)))
            for phase, secs in sorted(self.device.items()):
                out.append(Sample(
                    f"{prefix}_device_{phase.replace('.', '_')}"
                    f"_seconds_total", "counter",
                    f"device seconds of {phase!r} over the read replays",
                    secs))
            return out

        registry.register_collector(collect)


def _index(batch, i: int):
    """Step `i` of a stacked (nested) batch dict."""
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    return batch[i]


def _clone(tree):
    """A copy of a (nested) dict of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class Trainer:
    """Single-device training loop.  Runs on CUDA unless `device` says
    otherwise (see `singa_tpu_torch.device`)."""

    def __init__(self, model_cfg: ModelConfig,
                 input_shapes: Dict[str, Dict[str, tuple]],
                 log_fn: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None, seed: int = 0,
                 graphs: Optional[bool] = None, health=None,
                 ngroups: int = 1, dp=None, n_micro: int = 0):
        """`seed` seeds the per-step generators of the layers that draw
        (see `Context.layer_rng`); params come from `init(seed)`.

        When UpdaterProto's consistency knobs request the async tier
        (param_type Elastic with moving_rate > 0, or RandomSync), `run`
        exchanges params with a center copy at sync_frequency after
        warmup_steps (worker.cc:44-55); `ngroups` scales Elastic's
        alpha = moving_rate/ngroups (param_manager.cc:15).

        `health` (a `utils.health.HealthMonitor`) arms the numeric-health
        sentinel: the train step also returns the health probes (in the
        graph too), the drain classifies each step, a fatal verdict
        raises `NumericDivergence`, and saves carry (and are gated on)
        the window's verdict.  None runs exactly the step without them.

        `graphs` picks how the steps run.  None: as CUDA-graph replays
        on CUDA, eagerly on the CPU.  True: as replays, or raise (on the
        CPU).  False: eagerly.  A capture that fails raises
        `CaptureError`; nothing falls back to eager steps.  `self.graphs`
        holds the choice.

        `dp` (a `parallel.partition.DataParallel` over more than one
        process) trains on this rank's part of each global batch with its
        shards of the params, and averages gradients and metrics over
        the data × seq ranks; its steps run eagerly (a gloo collective
        cannot be captured), so `graphs` must not be True.  Under a pipe
        axis above 1 a net with `locationid` stages runs pipelined with
        `n_micro` microbatches (0: 2·pipe)."""
        self.cfg = model_cfg
        self.seed = seed
        self.health = health
        self.log = log_fn if log_fn is not None \
            else (lambda msg: print(f"[trainer] {msg}", flush=True))
        self.device = resolve_device(device)
        self.dp = (dp if dp is not None and (dp.n > 1 or dp.world > 1)
                   else None)
        if self.dp is not None and graphs:
            raise ValueError("graphs=True cannot capture a step over "
                             "several processes: its gloo collectives run "
                             "on the host")
        self.compute_dtype = (torch.bfloat16
                              if model_cfg.precision == "bfloat16" else None)
        self.train_net = build_net(model_cfg, "kTrain", input_shapes)
        self.test_net = self._maybe_net("kTest", input_shapes)
        self.val_net = self._maybe_net("kValidation", input_shapes)
        self._pipeline_nets = self._maybe_pipeline(n_micro)
        if self.dp is not None:
            from ..parallel.partition import uses_sequence_parallel
            self.dp.bind(self.train_net, uses_sequence_parallel(model_cfg),
                         pipeline=self._pipeline_nets.get(
                             id(self.train_net)))
        self.updater = make_updater(model_cfg.updater)
        self.multipliers = self.train_net.multipliers()
        from ..parallel.elastic import ElasticController, async_active
        self.elastic = (ElasticController(model_cfg.updater, ngroups,
                                          log_fn=self.log)
                        if async_active(model_cfg.updater) else None)
        # a step over several processes (a data, model or seq axis) runs
        # eager: its gloo collectives, staged through the host, cannot be
        # captured
        self.graphs = self._pick_graphs(False if self.dp else graphs)
        # one generator per drawing layer of the train net, keyed by its
        # topological index, seeded before every step (`_seed_layers`)
        self._gens = {i: torch.Generator(device=self.device)
                      for i in self.train_net.drawing_layers()}
        # the params ("params") and optimizer state ("opt") that every
        # graph of this trainer was captured over
        self._state: Dict[str, Any] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.timer = TimerInfo()
        self._train_graph = (StepGraph("train_step", self._pool,
                                       writes=("params", "opt"),
                                       generators=tuple(self._gens.values()),
                                       on_marks=self.timer.add_marks)
                             if self.graphs else None)
        perf.time_source(self.timer.program_seconds)
        # contrastive divergence: the chain's generator, one graph per
        # RBM (keyed by its index) and the PCD chains (`cd_step`)
        cd = model_cfg.alg == "kContrastiveDivergence"
        self._cd_gen = torch.Generator(device=self.device) if cd else None
        self._cd_graph = (StepGraph("cd_step", self._pool,
                                    writes=("params", "opt", "chain"),
                                    generators=(self._cd_gen,))
                          if cd and self.graphs else None)
        self._chains: Dict[int, torch.Tensor] = {}
        self.test_step = self._eval_step(self.test_net)
        self.val_step = self._eval_step(self.val_net)
        self.perf = Performance()
        # `run` profiles the phases at its first display step when set
        # (or SINGA_TPU_PHASE_PROFILE=1); the last profile's device time
        # by (phase, kernel), phase None for unattributed work
        self.phase_profile = False
        self.phase_kernels: Dict[tuple, float] = {}
        self._train_harvested = False
        # post-save publication hook (step, verdict): runs after a
        # snapshot and its verdict are on disk; a raising hook is logged
        self.on_checkpoint: Optional[Callable[[int, Optional[str]],
                                              None]] = None
        for nm, freq, steps in (
                ("test", model_cfg.test_frequency, model_cfg.test_steps),
                ("validation", model_cfg.validation_frequency,
                 model_cfg.validation_steps)):
            if freq > 0 and steps <= 0:
                self.log(f"warning: {nm}_frequency is set but {nm}_steps "
                         f"is 0 — no {nm} net is built and {nm} "
                         f"evaluation will not run (worker.cc:16-27)")

    def _maybe_pipeline(self, n_micro: int) -> Dict[int, Any]:
        """{id(net): PipelineNet} when the config marks stages AND the
        mesh has a pipe axis > 1; {} otherwise (locationid marks are
        inert on a flat mesh, matching the reference running a
        location-annotated net on a single worker)."""
        has_pipe = self.dp is not None and self.dp.pipe.n > 1
        staged = any(l.locationid > 0 for l in self.cfg.neuralnet.layer)
        if not (has_pipe and staged):
            return {}
        from ..parallel.pipeline_net import (HeteroPipelineNet,
                                             NonUniformStages, PipelineNet)
        n_micro = n_micro or 2 * self.dp.pipe.n
        nets = {}
        for net in (self.train_net, self.test_net, self.val_net):
            if net is not None:
                try:
                    nets[id(net)] = PipelineNet(net, n_micro)
                except NonUniformStages as e:
                    # the reference pipelines arbitrary locationid
                    # layouts (neuralnet.cc:198-323); stages of other
                    # structure take the heterogeneous form
                    self.log(f"pipeline: stages not uniform ({e}); using "
                             f"HeteroPipelineNet")
                    nets[id(net)] = HeteroPipelineNet(net, n_micro)
        return nets

    def _net_apply(self, net):
        """net.apply, or the pipelined equivalent when configured."""
        pnet = self._pipeline_nets.get(id(net))
        return net.apply if pnet is None else pnet.apply

    def _pick_graphs(self, graphs: Optional[bool]) -> bool:
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
        compute_dtype, seed, state, dp = self.compute_dtype, self.seed, \
            self._state, self.dp
        apply = self._net_apply(net)
        program = f"eval_step[{net.phase}]"
        harvested = []

        def forward(params, batch):
            if not harvested:   # at the capture, or the first eager call
                perf.harvest(program, flops=net_forward_flops(net))
                harvested.append(program)
            if dp is not None:  # every row; a seq chunk under SP
                batch = dp.shard(batch, rows=False)
            with torch.no_grad():
                _, metrics, _ = apply(params, batch, train=False,
                                      compute_dtype=compute_dtype,
                                      rng=seed, par=dp)
            if dp is not None and dp.seq_sharding:
                metrics = dp.mean_dict(metrics, group=dp.seq_group)[0]
            return metrics
        if not self.graphs:
            return forward
        graph = StepGraph(program, self._pool)

        def eval_step(params, batch):
            return graph(forward, _own(state, params)["params"], batch)
        return eval_step

    # -- init --------------------------------------------------------------
    def init(self, seed: int = 0):
        """Params from `seed` and their optimizer state; over a model
        axis this rank's shards of them (every rank draws the whole
        params from the same seed)."""
        params = self.train_net.init_params(seed, device=self.device)
        if self.dp is not None:
            params = self.dp.shard_params(params)
        return params, self.updater.init(params)

    # -- steps -------------------------------------------------------------
    def _seed_layers(self, step: Optional[int]) -> None:
        """Seed each drawing layer's generator for `step`: host state that
        the next eager draw or replay reads (never inside a capture)."""
        for i, gen in self._gens.items():
            gen.manual_seed(layer_seed(self.seed, step, i))

    def gradients(self, params: Dict[str, torch.Tensor], batch,
                  step: Optional[int] = 0) -> tuple:
        """(metrics, grads) of one forward and backward at `step`: `grads`
        maps every param to its gradient, or to None where none reached
        it."""
        self._seed_layers(step)
        return self._grads(params, batch, step)[:2]

    def _grads(self, params, batch, step: Optional[int]) -> tuple:
        """`gradients` with the generators as they stand, and the layer
        outputs: (metrics, grads, outputs).  Under `dp` `batch` is the
        global batch, of which this rank takes its part (drawing layers
        keep their part of the global draw), and the gradients are this
        rank's, not yet averaged."""
        shard = None
        if self.dp is not None:
            batch, shard = self.dp.shard(batch), self.dp.shard_spec
        names = sorted(params)
        tensors = [params[k] for k in names]
        for p in tensors:
            p.requires_grad_(True)
        try:
            with profiler.phase("fwd"):
                loss, metrics, outputs = self._net_apply(self.train_net)(
                    params, batch, train=True,
                    compute_dtype=self.compute_dtype, rng=self.seed,
                    step=step, generators=self._gens, shard=shard,
                    par=self.dp)
            mark("step.forward")
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
            mark("step.backward")
        finally:
            for p in tensors:
                p.requires_grad_(False)
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)), outputs)

    def _step(self, params, opt_state, batch, step: Optional[int],
              poison: Optional[float] = None):
        """Forward, backward and the update of the step last written by
        `Updater.set_step`, drawing from the generators as seeded: the
        device work of one train step, eager or captured.  Under `dp`
        the global `batch` is sliced in `_grads`, and the gradients and
        metrics are averaged over the data × seq ranks before the
        update.  `poison` (a
        `step.grad` fault's scale) multiplies the gradients first.  With a
        health monitor the metrics gain the probes, over a copy of the
        params taken before the update (the updater writes them in
        place).  Captured, it records the device marks of
        `DEVICE_PHASES` (`core/step_graph.py` `mark`)."""
        mark("step.start")
        metrics, grads, _ = self._grads(params, batch, step)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in grads.items()}
        if self.dp is not None:
            # a param whole on every pipe rank has its parts on several
            # ranks; the mean over data × seq of the ranks' gradients is
            # the global batch's; the model and expert axes hold shards
            grads = self.dp.pipe_sum(grads)
            grads, metrics = self.dp.mean_dict(grads, metrics)
        if poison is not None:
            grads = {k: g * poison for k, g in grads.items()}
        old = None
        if self.health is not None:
            # one multi-tensor copy (x * 1.0 is exact)
            names = list(params)
            old = dict(zip(names, torch._foreach_mul(
                [params[k] for k in names], 1.0)))
        with profiler.phase("update"):
            self.updater.apply(grads, params, opt_state,
                               multipliers=self.multipliers)
        mark("step.update")
        if old is not None:
            from ..utils.health import health_probes
            metrics = {**metrics, **health_probes(
                grads, old, params,
                model=(self.dp if self.dp is not None
                       and self.dp.gathers else None))}
        return metrics

    def _train_body(self, state, batch, step: int):
        # `step` reaches only the host decisions of `step_variant`, which
        # key the graph; the draws come from the seeded generators
        return self._step(state["params"], state["opt"], batch, step)

    def train_step(self, params, opt_state, batch, step: int,
                   poison: Optional[float] = None):
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
        outputs, which the next replay overwrites.

        `poison` (None normally) is a `step.grad` fault's gradient scale;
        under `graphs` such a step runs eagerly on the graphs' own
        tensors (replays and eager steps are bit-equal, draws included),
        so no graph branches and a step without a fault replays as
        always."""
        if not self._train_harvested:   # at the capture, or the first step
            perf.harvest("train_step", flops=net_train_flops(self.train_net))
            self._train_harvested = True
        if not self.graphs:
            with obs.span("trainer.step_prepare", step=step):
                self.updater.set_step(step, params, self.multipliers)
                self._seed_layers(step)
            return params, opt_state, self._step(params, opt_state, batch,
                                                 step, poison)
        with obs.span("trainer.step_prepare", step=step):
            state = _own(self._state, params, opt_state)
            self.updater.set_step(step, state["params"], self.multipliers)
            if poison is None:
                both = {"params": state["params"], "opt": state["opt"]}
                body = functools.partial(self._train_body, step=step)
                key = self.train_net.step_variant(step)
                # warm-up draws from the generators: capture before
                # seeding (at the geometry's first step only)
                self._train_graph.capture(body, both, batch, key)
            self._seed_layers(step)
        if poison is not None:
            return state["params"], state["opt"], self._step(
                state["params"], state["opt"], batch, step, poison)
        with obs.span("trainer.replay", step=step):
            metrics = self._train_graph(body, both, batch, key)
        return state["params"], state["opt"], metrics

    def train_steps(self, params, opt_state, batches, start_step: int,
                    nsteps: int, stacked: bool = False, poison=None):
        """`nsteps` steps from `start_step` with no host sync between
        them, the reference's `lax.scan` (`:376-433`): with `stacked`,
        every leaf of `batches` carries a leading `nsteps` axis (a fresh
        batch per step), else one batch is reused.  Each step's metrics
        are copied into an (nsteps,) slot per key on the device before
        the next step can overwrite them; returns (params, opt_state,
        those stacked metrics).  `poison` (None normally) holds a
        gradient scale per step, 1.0 where no `step.grad` fault fired."""
        if stacked:
            bad = [tuple(x.shape) for x in leaves(batches)
                   if x.ndim < 1 or x.shape[0] != nsteps]
            if bad:
                raise ValueError(f"stacked=True needs a leading {nsteps}-"
                                 f"axis on every batch leaf; got {bad}")
        out = None
        for i in range(nsteps):
            batch = _index(batches, i) if stacked else batches
            pz = None if poison is None or poison[i] == 1.0 else poison[i]
            params, opt_state, m = self.train_step(params, opt_state, batch,
                                                   start_step + i, pz)
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

    # -- measuring the step (`:474-487`, `:519-556`) -------------------------
    def _gen_states(self) -> Dict[int, torch.Tensor]:
        return {i: g.get_state() for i, g in self._gens.items()}

    def _set_gen_states(self, states: Dict[int, torch.Tensor]) -> None:
        for i, st in states.items():
            self._gens[i].set_state(st)

    def profile_phases(self, params, opt_state, batch, step: int = 0,
                       outdir: Optional[str] = None) -> Dict[str, float]:
        """Measure the device's fwd/bwd/update split of the train step
        (worker.h:91-114's tForward_/tBackward_/tSyncParam_ report) and
        pin it on `self.timer` for every later TimerInfo line.

        One EAGER step at `step` on clones of `params` and `opt_state` is
        traced with `torch.profiler` into `outdir` (a temporary directory
        by default) and attributed by `utils.profiler.phase_shares`: a
        replayed graph is one launch, which no trace splits into phases.
        (`run` profiles after its first step, which paid the first-call
        setup.)  The run's params, optimizer state and generators are
        left as they were, and no batch is drawn.  Returns the shares;
        the time by (phase, kernel) lands in `self.phase_kernels`."""
        import tempfile
        outdir = outdir or tempfile.mkdtemp(prefix="singa_phase_prof_")
        cp, co = _clone(params), _clone(opt_state)
        saved = self._gen_states()
        try:
            self.updater.set_step(step, cp, self.multipliers)
            self._seed_layers(step)
            profiler.hard_sync(cp)
            with profiler.trace(outdir) as prof:
                self._step(cp, co, batch, step)
                profiler.hard_sync(cp)
        finally:
            self._set_gen_states(saved)
        events = prof.events()
        self.phase_kernels = profiler.attribute(events)[0]
        shares = profiler.phase_shares(events)
        self.timer.phase_shares = shares
        return shares

    def debug_step(self, params, batch, step: int) -> tuple:
        """(outputs, grads) of one eager forward and backward at `step`
        for `NeuralNet.debug_info` (neuralnet.cc:350-378 prints data and
        gradient norms): every layer's output and every param's gradient
        (zeros where none reaches it), drawing what step `step` draws.
        Nothing is updated, and the generators are left as they were."""
        saved = self._gen_states()
        try:
            self._seed_layers(step)
            _, grads, outputs = self._grads(params, batch, step)
        finally:
            self._set_gen_states(saved)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in grads.items()}
        return outputs, grads

    def _phase_profile_on(self) -> bool:
        return bool(self.phase_profile) or \
            os.environ.get("SINGA_TPU_PHASE_PROFILE") == "1"

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
        back stacked; and, with the elastic tier, none runs past a sync
        step.  The reference's `_next_chunk_len` (`:693-733`)."""
        n = min(scan_chunk, self.cfg.train_steps - step)

        def next_event(freq, after):
            # smallest multiple of freq that is > step and >= after
            if freq <= 0:
                return None
            m = (step // freq + 1) * freq
            if m < after:
                m = -(-after // freq) * freq
            return m

        if self.elastic is not None:
            # chunks may not run past a sync step: the center exchange
            # runs on the host after that step
            freq = self.cfg.updater.sync_frequency
            warm = self.cfg.updater.warmup_steps
            e = (warm if step < warm
                 else warm + ((step - warm) // freq + 1) * freq)
            if self.elastic.sync_now(step):
                e = step
            n = min(n, e - step + 1)
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
    @staticmethod
    def _feeder_on(feeder: Optional[bool]) -> bool:
        """The overlapped feed is on by default for chunked loops; an
        explicit argument wins, then SINGA_TPU_FEEDER=0/1."""
        if feeder is not None:
            return bool(feeder)
        return os.environ.get("SINGA_TPU_FEEDER", "1") != "0"

    @staticmethod
    def _feeder_depth(depth: int = 0) -> int:
        """Staged chunks ahead: the argument, then SINGA_TPU_FEEDER_DEPTH,
        default 2."""
        if depth and depth > 0:
            return int(depth)
        try:
            return max(1, int(os.environ.get("SINGA_TPU_FEEDER_DEPTH",
                                             "2")))
        except ValueError:
            return 2

    def _chunk_plan(self, start_step: int, scan_chunk: int):
        """The (start, length) chunks covering [start_step, train_steps)
        with the loop's own cadence cuts, so a `DeviceFeeder` stages
        exactly the batches the loop trains on."""
        step = start_step
        while step < self.cfg.train_steps:
            n = self._next_chunk_len(step, scan_chunk)
            yield step, n
            step += n

    def run(self, params, opt_state, train_iter: Iterator,
            test_iter_factory: Optional[Callable[[], Iterator]] = None,
            val_iter_factory: Optional[Callable[[], Iterator]] = None,
            start_step: int = 0, seed: Optional[int] = None,
            hooks: Optional[List[Callable[[int, Dict], None]]] = None,
            workspace: Optional[str] = None, scan_chunk: int = 0,
            feeder: Optional[bool] = None, feeder_depth: int = 0):
        """The Worker::Run loop (worker.cc:98-106).  With `workspace` and
        checkpoint_frequency > 0, saves {params, opt_state, step} after
        each step s >= checkpoint_after_steps with (s+1) %
        checkpoint_frequency == 0, and at the end.  Returns (params,
        opt_state, history of test averages).  `seed`, when given,
        replaces the trainer's seed for the layers that draw.

        `scan_chunk > 1` runs chunks of up to that many steps through
        `train_steps`, cut at every test, validation and checkpoint
        boundary (`_next_chunk_len`).  A chunk is staged through
        `data.feed`: by a `DeviceFeeder` thread that runs `feeder_depth`
        chunks ahead (`feeder` None or True; SINGA_TPU_FEEDER=0 turns
        the default off), or inline (`feeder=False`); both give the same
        trajectory bit for bit.  A chunk's metrics stay on the device
        until it is drained: one fetch per chunk, deferred by up to
        `feeder_depth` chunks under the feeder and drained before every
        display, evaluation and save; then the health monitor, the
        hooks, `Performance` and the display lines run per step, in step
        order.  `scan_chunk` 0 (or 1) runs one step and one fetch per
        iteration.

        While a checkpoint manager is active, SIGTERM/SIGINT (on the
        main thread) save at the current step and return; the handlers
        are restored on every exit.

        An `alg: kContrastiveDivergence` config trains through `run_cd`
        (the feeder arguments do not apply)."""
        cfg = self.cfg
        if cfg.alg == "kContrastiveDivergence":
            return self.run_cd(params, opt_state, train_iter,
                               test_iter_factory=test_iter_factory,
                               val_iter_factory=val_iter_factory,
                               hooks=hooks, scan_chunk=scan_chunk,
                               start_step=start_step, seed=seed,
                               workspace=workspace)
        if seed is not None:
            self.seed = seed
        ckpt, interrupted, old_handlers = self._ckpt_guard(workspace)
        if self.elastic is not None:
            # the center seeds lazily from the first post-warmup params
            # inside maybe_sync (worker.cc:50-55 pushes AFTER warmup)
            self.log(f"async consistency tier active: "
                     f"{cfg.updater.param_type} sync_frequency="
                     f"{cfg.updater.sync_frequency} warmup="
                     f"{cfg.updater.warmup_steps}")
        history: List[Dict[str, float]] = []
        chunked = scan_chunk > 1
        step = start_step
        fd = stager = None
        if chunked and self._feeder_on(feeder):
            from ..data.feed import DeviceFeeder
            fd = DeviceFeeder(train_iter,
                              self._chunk_plan(start_step, scan_chunk),
                              self.device,
                              depth=self._feeder_depth(feeder_depth),
                              capacity=scan_chunk)
        elif chunked:
            from ..data.feed import ChunkStager
            stager = ChunkStager(self.device, capacity=scan_chunk)
        # chunks whose metrics are still on the device; under the feeder
        # up to depth+1, else 1 (a fetch per iteration)
        ring = self._feeder_depth(feeder_depth) + 1 if fd is not None else 1
        pending: List[tuple] = []
        staged_credit = [0.0]
        saved = None
        stopped = False     # by a signal, here or on another rank
        # the newest chunk's last batch, for the debug step and the
        # phase profile
        last_batch = [None]

        def drain():
            if pending:
                with obs.span("trainer.drain", chunks=len(pending)):
                    drain_chunks()

        def drain_chunks():
            while pending:
                s0, stacked = pending.pop(0)
                t = time.perf_counter()
                per_step = self.drain_metrics(stacked)
                self.timer.add("train", time.perf_counter() - t)
                for s, metrics in enumerate(per_step, start=s0):
                    if self.health is not None:
                        self._observe(s, metrics)
                    self.perf.update(metrics)
                    for hook in hooks or ():
                        self._call_hook(hook, s, metrics)
                    if self.display_now(s):
                        if (self.timer.phase_shares is None
                                and self._phase_profile_on()):
                            # one-shot; a profiler failure is logged and
                            # never stops training
                            try:
                                self.profile_phases(params, opt_state,
                                                    last_batch[0], step=s)
                            except Exception as e:  # noqa: BLE001
                                self.timer.phase_shares = {}
                                self.log(f"warning: phase profile failed: "
                                         f"{type(e).__name__}: {e}")
                        self.log(f"step-{s}: {self.perf.to_string()}")
                        self.log(self.timer.to_string())
                        self.perf.reset()

        try:
            while step < cfg.train_steps:
                faults.maybe_fault("step.train")
                if self._interrupt(interrupted):
                    drain()   # hooks and logs of every trained step first
                    who = (f"signal {interrupted[0]} received"
                           if interrupted else "another rank got a signal")
                    self.log(f"{who}: checkpointing at step {step} and "
                             f"stopping")
                    self._save_checkpoint(ckpt, step, params, opt_state)
                    stopped = True
                    break
                if self.val_step and self.validate_now(step) \
                        and val_iter_factory:
                    drain()
                    avg = self.evaluate(params, val_iter_factory(),
                                        cfg.validation_steps, self.val_step)
                    self.log(f"step-{step} validation: " + ", ".join(
                        f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
                if self.test_step and self.test_now(step) \
                        and test_iter_factory:
                    drain()
                    avg = self.evaluate(params, test_iter_factory(),
                                        cfg.test_steps, self.test_step)
                    self.log(f"step-{step} test: " + ", ".join(
                        f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
                    history.append({"step": step, **avg})
                n = self._next_chunk_len(step, scan_chunk) if chunked else 1
                poison = self._grad_poison(n)
                t0 = time.perf_counter()
                if not chunked:
                    batch = next(train_iter)
                    t1 = time.perf_counter()
                    # the JAX loop places the batch here (`_batch_place`,
                    # a no-op without a mesh); the port's step copies the
                    # host batch itself, so this stage holds no work
                    t2 = time.perf_counter()
                    with obs.span("trainer.chunk", start=step, steps=1):
                        params, opt_state, m = self.train_step(
                            params, opt_state, batch, step,
                            poison[0] if poison is not None else None)
                    # drained before the next replay overwrites them
                    # (the ring is 1 without the feeder)
                    stacked = {k: v.reshape(1) for k, v in m.items()}
                    last_batch[0] = batch
                else:
                    if fd is not None:
                        with obs.span("feeder.wait", start=step):
                            chunk = fd.get()
                        if chunk.start != step or chunk.length != n:
                            from ..data.feed import FeedError
                            raise FeedError(
                                f"feed plan diverged: staged chunk "
                                f"[{chunk.start}, +{chunk.length}) vs "
                                f"loop [{step}, +{n})")
                        self.timer.add("stage",
                                       fd.stage_seconds - staged_credit[0])
                        staged_credit[0] = fd.stage_seconds
                        t1 = t2 = time.perf_counter()
                    else:
                        batches = [next(train_iter) for _ in range(n)]
                        t1 = time.perf_counter()
                        with obs.span("feeder.stage", start=step, steps=n):
                            chunk = stager.stage(batches)
                        t2 = time.perf_counter()
                    batches = chunk.take()
                    with obs.span("trainer.chunk", start=step, steps=n):
                        params, opt_state, stacked = self.train_steps(
                            params, opt_state, batches, step, n,
                            stacked=True, poison=poison)
                    last_batch[0] = _index(batches, n - 1)
                t3 = time.perf_counter()
                pending.append((step, stacked))
                self.timer.add("wait", t1 - t0)
                if t2 > t1:
                    self.timer.add("stage", t2 - t1)
                self.timer.add("train", t3 - t2)
                self.timer.steps += n
                # the first train dispatch latches the cold start
                perf.mark_training_ready()
                shown = any(self.display_now(step + i) for i in range(n))
                if len(pending) >= ring or shown:
                    drain()
                if self.cfg.debug and shown:
                    # the norms are of the post-chunk params, so they are
                    # labelled with the chunk's last step
                    s_dbg = step + n - 1
                    outs, grads = self.debug_step(params, last_batch[0],
                                                  s_dbg)
                    self.log(f"step-{s_dbg} debug:\n" +
                             self.train_net.debug_info(params, outs, grads))
                last = step + n - 1
                if self.elastic is not None:
                    # chunks are cut so at most the LAST step is a sync
                    # step; the exchange writes the params in place
                    params = self.elastic.maybe_sync(
                        last, params, rng=fold_in(self.seed ^ 0x5eed, last))
                if (ckpt is not None and last >= cfg.checkpoint_after_steps
                        and (last + 1) % cfg.checkpoint_frequency == 0):
                    # drain first: every step the snapshot holds has been
                    # classified and seen by the hooks, and a poisoned
                    # state never reaches the save
                    drain()
                    self._save_checkpoint(ckpt, last + 1, params, opt_state)
                    saved = last + 1
                step += n
            drain()
        finally:
            # an exception mid-loop (an injected fault, a data failure)
            # must leave neither our signal handlers nor the feed thread
            if fd is not None:
                fd.close()
            self._ckpt_unguard(old_handlers)
        # the final snapshot, unless the cadence just wrote it: a second
        # save of that step would record the verdict of an empty window
        # ("ok") over the one it holds
        if (ckpt is not None and not (interrupted or stopped)
                and cfg.train_steps > start_step
                and saved != cfg.train_steps):
            self._save_checkpoint(ckpt, cfg.train_steps, params, opt_state)
        if self.dp is not None:
            # rank 0's snapshots are on disk before any rank returns
            self.dp.barrier()
        return params, opt_state, history

    # -- contrastive divergence (`:1125-1247`) ------------------------------
    def rbm_names(self) -> List[str]:
        """The train net's kRBM layers, in topological order."""
        net = self.train_net
        names = [n for n in net.topo
                 if getattr(net.layers[n], "is_rbm", False)]
        if not names:
            raise ValueError("alg kContrastiveDivergence needs at least "
                             "one kRBM layer in the net")
        return names

    def _cd_input(self, params, batch, name: str) -> torch.Tensor:
        """RBM `name`'s visible batch: the net's prefix before it, run
        with train=False, flattened to (B, nvis) in f32."""
        net = self.train_net
        with torch.no_grad():
            _, _, outputs = net.apply(
                params, batch, train=False, compute_dtype=self.compute_dtype,
                layer_subset=net.topo[:net.topo.index(name)],
                shard=self.dp.shard_spec if self.dp is not None else None,
                par=self.dp)
        v = outputs[net.layers[name].cfg.srclayers[0]]
        return v.reshape(v.shape[0], -1).float()

    def _cd_view(self, layer, params):
        """The RBM's {W, bv, bh}, each whole: over a model axis a sharded
        one is gathered at use, as the port's unpartitioned layers take
        theirs (`ModelShards.full`)."""
        tp = self.dp.view() if self.dp is not None else None
        if tp is None:
            return layer.cd_view(params)
        return layer.cd_view({k: tp.full(params, k) if k in tp.dims
                              else params[k]
                              for k in (layer.w_key, layer.bv_key,
                                        layer.bh_key)})

    def _cd_uniform(self):
        """The chain's uniform source: the generator, or under a data axis
        a draw at the global batch's rows of which this rank keeps its
        own (`Context.global_rows`' rule), so the ranks' chains together
        draw what one process's chain draws."""
        gen = self._cd_gen
        if self.dp is None or self.dp.n == 1:
            return gen
        index, n, dev = self.dp.index, self.dp.n, self.device

        def draw(shape):
            b = shape[0]
            return torch.rand((b * n,) + tuple(shape[1:]), generator=gen,
                              device=dev)[index * b:(index + 1) * b]
        return draw

    @torch.no_grad()
    def _cd_body(self, state, batch, name: str):
        """One CD step of RBM `name`, eager or captured: its input, CD-k
        from the chain's generator (from `state["chain"]`, the PCD
        buffer, when there is one; it receives the chain's end), and the
        update of its params only, at the step `Updater.set_step` last
        wrote.  Under `dp` `batch` is this rank's rows: the gradients
        (this rank's shards of them over a model axis) and the
        reconstruction error, each a mean over the rank's rows, are
        averaged over the data × seq ranks, which gives the global
        batch's."""
        layer = self.train_net.layers[name]
        params, opt = state["params"], state["opt"]
        from ..models.rbm import cd_grads
        v = self._cd_input(params, batch, name)
        chain = state.get("chain")
        grads, recon, end = cd_grads(self._cd_view(layer, params), v,
                                     self._cd_uniform(), k=layer.cd_k,
                                     persistent=chain)
        named = layer.named_grads(grads)
        if self.dp is not None:
            named, m = self.dp.mean_dict(self.dp.shard_params(named),
                                         {"recon": recon})
            recon = m["recon"]
        self.updater.apply(
            named, {k: params[k] for k in named},
            {slot: {k: d[k] for k in named} for slot, d in opt.items()},
            {k: self.multipliers[k] for k in named})
        if chain is not None:
            chain.copy_(end)
        return {"recon": recon}

    def cd_step(self, params, opt_state, batch, step: int, idx: int,
                fresh: bool = False):
        """One CD-k step of the `idx`-th RBM at `step`, updating its params
        and their optimizer state in place; returns (params, opt_state,
        {"recon": 0-d tensor}).  The chain's generator is seeded from
        (seed ^ 0xCD, step), as `fold_in(PRNGKey(seed ^ 0xCD), step)` in
        the JAX package.  A persistent (PCD) RBM carries its chain in a
        buffer of this trainer; `fresh` restarts it from this batch's
        data (the first step of its phase in a run).  Under `graphs` the
        step replays the RBM's own graph, and the graphs own params and
        state as `train_step`'s do.  Under `dp` `batch` is the global
        batch, of which this rank trains on its rows (its chain holds
        those rows only)."""
        name = self.rbm_names()[idx]
        layer = self.train_net.layers[name]
        if self.graphs:
            own = _own(self._state, params, opt_state)
            params, opt_state = own["params"], own["opt"]
        keys = [spec.name for spec in layer.param_specs]
        self.updater.set_step(step, {k: params[k] for k in keys},
                              self.multipliers)
        state = {"params": params, "opt": opt_state}
        if self.dp is not None:
            batch = self.dp.shard(batch)
        if layer.persistent:
            buf = self._chains.get(idx)
            if buf is None:
                b = self.train_net.shapes[name][0] // (
                    self.dp.n if self.dp is not None else 1)
                buf = self._chains[idx] = torch.zeros(
                    (b, layer.nvis), device=self.device)
            if fresh:
                buf.copy_(self._cd_input(params, batch, name))
            state["chain"] = buf
        body = functools.partial(self._cd_body, name=name)
        seed = fold_in(self.seed ^ 0xCD, step)
        if not self.graphs:
            self._cd_gen.manual_seed(seed)
            return params, opt_state, body(state, batch)
        # warm-up draws from the generator: capture before seeding
        self._cd_graph.capture(body, state, batch, idx)
        self._cd_gen.manual_seed(seed)
        return params, opt_state, self._cd_graph(body, state, batch, idx)

    def run_cd(self, params, opt_state, train_iter: Iterator,
               test_iter_factory=None, val_iter_factory=None,
               hooks: Optional[List[Callable[[int, Dict], None]]] = None,
               scan_chunk: int = 0, start_step: int = 0,
               seed: Optional[int] = None, workspace: Optional[str] = None):
        """kContrastiveDivergence training (ModelProto.alg,
        model.proto:40-44): greedy layer-wise CD-k over the net's kRBM
        layers.  The budget splits evenly across the RBMs: step s trains
        RBM min(s·n // train_steps, n-1), on the hidden probabilities of
        the ones before it, one `cd_step` a step.
        RBMProto.persistent runs PCD: the chain continues from the last
        step's end; it starts from the data at the first step of its
        phase in a run (so from the data again on resume).  Each step's
        reconstruction error is fetched (one sync a step), feeds the
        display lines (`step-N cd[rbmI]: recon : ...`, also appended to
        the returned history) and reaches the hooks as {"recon", "rbm"}.
        The `step.train` fault site, the checkpoint cadence and the
        SIGTERM/SIGINT snapshot behave as in `run`, over processes too
        (rank 0 saves whole params, a signal to any rank stops all at one
        step, and every rank waits for the last save); the last step is
        saved once.  Returns (params, opt_state, history)."""
        cfg = self.cfg
        if seed is not None:
            self.seed = seed
        names = self.rbm_names()
        if scan_chunk and scan_chunk > 1:
            self.log("warning: scan_chunk is not supported for CD "
                     "training (host-side greedy phase switching); "
                     "running per-step")
        for nm, it, step_fn in (("test", test_iter_factory, self.test_step),
                                ("validation", val_iter_factory,
                                 self.val_step)):
            if it is not None and step_fn is None:
                self.log(f"warning: {nm} iterator supplied but this CD "
                         f"net built no {nm} eval step (no loss layer "
                         f"in that phase); skipping {nm} evaluation "
                         "(reconstruction error is the training metric)")
        total, n = cfg.train_steps, len(names)
        history: List[Dict[str, float]] = []
        started = set()
        saved = None
        stopped = False     # by a signal, here or on another rank
        ckpt, interrupted, old_handlers = self._ckpt_guard(workspace)
        try:
            for step in range(start_step, total):
                faults.maybe_fault("step.train")
                if self._interrupt(interrupted):
                    who = (f"signal {interrupted[0]} received"
                           if interrupted else "another rank got a signal")
                    self.log(f"{who}: checkpointing at step {step} and "
                             f"stopping")
                    self._save_checkpoint(ckpt, step, params, opt_state)
                    stopped = True
                    break
                if (self.test_step and self.test_now(step)
                        and test_iter_factory):
                    avg = self.evaluate(params, test_iter_factory(),
                                        cfg.test_steps, self.test_step)
                    self.log(f"step-{step} test: " + ", ".join(
                        f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
                if (self.val_step and self.validate_now(step)
                        and val_iter_factory):
                    avg = self.evaluate(params, val_iter_factory(),
                                        cfg.validation_steps, self.val_step)
                    self.log(f"step-{step} validation: " + ", ".join(
                        f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
                idx = min(step * n // max(total, 1), n - 1)
                batch = next(train_iter)
                t0 = time.perf_counter()
                with obs.span("trainer.cd_step", step=step, rbm=idx):
                    params, opt_state, m = self.cd_step(
                        params, opt_state, batch, step, idx,
                        fresh=idx not in started)
                    recon = float(m["recon"])
                started.add(idx)
                self.timer.add("train", time.perf_counter() - t0)
                self.timer.steps += 1
                perf.mark_training_ready()
                self.perf.update({"recon": recon})
                for hook in hooks or ():
                    self._call_hook(hook, step, {"recon": recon, "rbm": idx})
                if self.display_now(step):
                    self.log(f"step-{step} cd[{names[idx]}]: "
                             f"{self.perf.to_string()}")
                    history.append({"step": step, "rbm": idx,
                                    **self.perf.averages()})
                    self.perf.reset()
                if (ckpt is not None and step >= cfg.checkpoint_after_steps
                        and (step + 1) % cfg.checkpoint_frequency == 0):
                    self._save_checkpoint(ckpt, step + 1, params, opt_state)
                    saved = step + 1
        finally:
            self._ckpt_unguard(old_handlers)
        # the final snapshot, unless the cadence just wrote it (the JAX
        # run_cd saves that step twice)
        if (ckpt is not None and not stopped and total > start_step
                and saved != total):
            self._save_checkpoint(ckpt, total, params, opt_state)
        if self.dp is not None:
            # rank 0's snapshots are on disk before any rank returns
            self.dp.barrier()
        return params, opt_state, history

    def _observe(self, step: int, metrics: Dict[str, float]) -> None:
        """Classify one drained step; raise on a fatal verdict, before
        the step reaches a hook or a save."""
        verdict = self.health.observe(step, metrics)
        if verdict.status != "ok":
            obs.emit_event("health.verdict", step=step,
                           status=verdict.status, metric=verdict.metric,
                           value=(float(verdict.value)
                                  if verdict.value is not None else None),
                           fatal=verdict.fatal)
        if verdict.fatal:
            raise verdict.to_error()

    def _grad_poison(self, n: int):
        """Visit the `step.grad` fault site once per step about to run;
        a list of n gradient scales when any fires, else None (the
        common case: every step replays its graph)."""
        if faults.active() is None:
            return None
        from ..utils.health import SPIKE_SCALE
        codes = [faults.maybe_fault("step.grad") for _ in range(n)]
        if not any(codes):
            return None
        scale = {"nan": float("nan"), "spike": SPIKE_SCALE}
        return [scale.get(c, 1.0) for c in codes]

    def _call_hook(self, hook, step, metrics) -> None:
        """User hooks are observers, not training logic: one that raises
        is logged and training continues."""
        try:
            hook(step, metrics)
        except Exception as e:  # noqa: BLE001 — any user-hook failure
            name = getattr(hook, "__name__", repr(hook))
            self.log(f"warning: user hook {name} raised at step {step} "
                     f"({type(e).__name__}: {e}); continuing")

    def _save_checkpoint(self, ckpt, step, params, opt_state) -> bool:
        """A cadence, final or signal snapshot, gated on the health
        verdict: a window the monitor classified as fatal is refused
        (restoring it would resume the divergence); a suspect (spike)
        window saves, with its verdict in MANIFEST.json, so a
        `skip_unhealthy` restore walks past it."""
        if ckpt is None:
            return False
        params, opt_state = self._ckpt_state(params, opt_state)
        if ckpt is _GATHER_ONLY:
            return False
        if self.health is None:
            ckpt.save(step, params, opt_state)
            self._publish(step, None)
            return True
        if not self.health.ok_to_save():
            rec = self.health.snapshot_health()
            self.log(f"health: refusing checkpoint at step {step} "
                     f"(verdict {rec['verdict']!r} — restoring this "
                     f"snapshot would resume the divergence)")
            obs.emit_event("ckpt.refused", step=step,
                           verdict=rec["verdict"])
            return False
        rec = self.health.snapshot_health()
        ckpt.save(step, params, opt_state, health=rec)
        self.health.mark_snapshot()
        self._publish(step, rec.get("verdict"))
        return True

    def _ckpt_state(self, params, opt_state):
        """(params, opt_state) as a snapshot holds them: whole and
        spec-shaped, gathered over the model and expert axes and from
        the pipe ranks (a collective every rank joins) and unpadded, so
        a snapshot restores under any mesh or none."""
        if self.dp is not None:
            params, opt_state = self.dp.gather_state(params, opt_state)
        net = self.train_net
        return (net.unpad_params(params),
                {k: net.unpad_params(t) for k, t in opt_state.items()})

    def _publish(self, step: int, verdict) -> None:
        """Run `on_checkpoint(step, verdict)` after the snapshot and its
        manifest record are on disk; a raising hook is logged, as a user
        hook is."""
        hook = self.on_checkpoint
        if hook is None:
            return
        try:
            hook(step, verdict)
        except Exception as e:  # noqa: BLE001 — observer, not logic
            self.log(f"warning: checkpoint publish hook raised at "
                     f"step {step} ({type(e).__name__}: {e}); "
                     f"continuing")

    def apply_lr_backoff(self, factor: float) -> float:
        """Scale the effective learning rate by `factor` (the
        Supervisor's divergence rescue).  The rate is a device scalar
        that `Updater.set_step` writes before every step, so captured
        graphs pick the scale up with no new capture.  Returns the
        cumulative scale."""
        self.updater.lr_scale *= float(factor)
        self.log(f"health: learning-rate backoff x{factor:g} applied "
                 f"(cumulative scale {self.updater.lr_scale:g})")
        return self.updater.lr_scale

    def _ckpt_guard(self, workspace):
        """(ckpt_manager, interrupted, old_handlers): the checkpoint
        manager of `run`, and SIGTERM/SIGINT handlers that note the
        signal, installed only on the main thread.  Pair with
        `_ckpt_unguard(old_handlers)`."""
        saving = bool(workspace) and self.cfg.checkpoint_frequency > 0
        ckpt = None
        if saving and (self.dp is None or self.dp.rank == 0):
            # every rank holds the same state (or its shard of it):
            # rank 0 writes it whole
            ckpt = CheckpointManager(workspace, log_fn=self.log,
                                     device=self.device)
        elif saving and self.dp.gathers:
            # the other ranks join the gather of every save
            ckpt = _GATHER_ONLY
        interrupted: List[int] = []
        old_handlers: Dict[Any, Any] = {}
        # under dp every rank notes a signal, and `_interrupt` stops them
        # all at one step, where rank 0 saves
        if saving:
            import signal

            def on_signal(signum, frame):
                interrupted.append(signum)

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, on_signal)
                except ValueError:   # not the main thread: no handlers
                    break
        return ckpt, interrupted, old_handlers

    def _interrupt(self, interrupted: List[int]) -> bool:
        """Whether to checkpoint and stop before the next step: a signal
        noted here, or under `dp` on any rank of the group (one flag
        all-reduced per step), so every rank stops at the same step."""
        if self.dp is None:
            return bool(interrupted)
        return self.dp.any(bool(interrupted))

    @staticmethod
    def _ckpt_unguard(old_handlers) -> None:
        if old_handlers:
            import signal
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def resume(self, params, opt_state, workspace: str,
               skip_unhealthy: bool = False):
        """Restore the latest restorable snapshot of `workspace`
        (Worker::Resume).  Returns (params, opt_state, start_step); the
        arguments come back unchanged with step 0 when there is none.  The
        snapshot's params and optimizer slots must match the net's and
        the updater's.  `skip_unhealthy` walks back past snapshots whose
        recorded health verdict is not "ok" (the Supervisor's divergence
        rescue).  Under `dp` the ranks must resume one state, as from one
        shared workspace (only rank 0 writes checkpoints): a rank that
        took up another step or other values raises RuntimeError on
        every rank, naming each rank's step."""
        restored = CheckpointManager(
            workspace, log_fn=self.log, device=self.device).restore(
            skip_unhealthy=skip_unhealthy)
        if restored is None:
            out = params, opt_state, 0
        else:
            rp, ro, step = restored
            if set(ro) != set(opt_state):
                raise ValueError(f"snapshot optimizer slots {sorted(ro)} != "
                                 f"this updater's {sorted(opt_state)}")
            out = (params_from_numpy(self.train_net, rp, device=self.device),
                   opt_state_from_numpy(self.train_net, ro,
                                        device=self.device),
                   step)
            if self.dp is not None:     # a snapshot is whole: re-shard it
                out = (*self.dp.shard_state(out[0], out[1]), step)
        if self.dp is not None:
            self.dp.agree(out[0], out[1], step=out[2],
                          what=f" on resuming from {workspace} (every "
                          f"rank must see the one workspace rank 0 writes)")
        return out


# the checkpoint manager of a rank that writes nothing but joins the
# gather of every save (`_ckpt_guard`)
_GATHER_ONLY = object()


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
