"""NeuralNet: NetProto config → a forward over a dict of torch tensors.

Port of `singa_tpu/core/net.py:43-163`, `217-240` and `285-354`: the
graph from `srclayers` edges, the topological sort, per-phase layer
filtering by `exclude`, shape setup in topo order, the param index with
`share_param` aliases, `init_params`, `multipliers` (`:165-168`) and
`apply`, the relu+LRN fusion (`:122-140`), the Slice-aware source
lookups (`:112-121`, `:346-351`), the layers' auxiliary losses
(`:333-338`), which join the total loss and the metrics as
"<layer>/aux", and `to_json` / `debug_info` (`:357-378`).  `apply`
takes the call's seed and step (`rng`, `step`), from which each layer
that draws (dropout, the RGB crop and mirror, the MNIST distortion)
seeds its own generator (`Context.layer_rng`), or the caller's
generators, seeded by the caller (`generators`, keyed by topological
index: the trainer's).  Mesh constraints, partition padding and remat
wait for the parallel slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.schema import ModelConfig, NetConfig
from ..device import DeviceLike, params_device, resolve_device
from .graph import Graph
from .init import init_param
from .layers import (Context, Layer, LayerError, LRNLayer, ParamSpec,
                     ReLULayer, SliceLayer, create_layer)
from .updater import Multipliers


def _to_device(batch, device: torch.device):
    """Numpy arrays and tensors of a (nested) batch dict, on `device`."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return batch


class NeuralNet:
    def __init__(self, net_cfg: NetConfig, phase: str = "kTrain",
                 input_shapes: Optional[Dict[str, Dict[str, tuple]]] = None,
                 batchsize: Optional[int] = None):
        """input_shapes: data-layer name → field → per-sample shape (no
        batch dim), e.g. {"data": {"input": (S,), "target": (S,)}}.
        `batchsize` overrides the data layers' batchsize."""
        self.phase = phase
        self.cfgs = [l for l in net_cfg.layer if phase not in l.exclude]
        self.input_shapes = input_shapes or {}
        self.batchsize_override = batchsize

        self.graph = Graph()
        for l in self.cfgs:
            self.graph.add_node(l.name, type=l.type)
        names = {l.name for l in self.cfgs}
        for l in self.cfgs:
            for src in l.srclayers:
                if src not in names:
                    raise LayerError(
                        f"layer {l.name!r}: unknown srclayer {src!r} "
                        f"in phase {phase}")
                self.graph.add_edge(src, l.name)
        self.topo = self.graph.topo_sort()

        self.layers: Dict[str, Layer] = {
            l.name: create_layer(l) for l in self.cfgs}
        self._setup()
        self._build_param_index()
        self._fuse_relu_lrn()

    # -- construction ------------------------------------------------------
    def _setup(self) -> None:
        shapes: Dict[str, Any] = {}
        for name in self.topo:
            layer = self.layers[name]
            src_shapes = [self._src_shape(shapes, src, name)
                          for src in layer.cfg.srclayers]
            if layer.is_data:
                sample = self.input_shapes.get(name)
                if sample is None:
                    raise LayerError(
                        f"data layer {name!r} needs input_shapes entry")
                layer.setup(src_shapes, sample_shapes=sample)
                if self.batchsize_override:
                    layer.batchsize = self.batchsize_override
                    layer.out_shape = {
                        k: (self.batchsize_override,) + tuple(v)
                        for k, v in sample.items()}
            else:
                layer.setup(src_shapes)
            shapes[name] = layer.out_shape
        self.shapes = shapes

    def _src_shape(self, shapes: Dict[str, Any], src: str, dst: str):
        out = shapes[src]
        if isinstance(out, tuple) and out and isinstance(out[0], tuple):
            # Slice layer: consumer i gets view i (base_layer.cc:114-173)
            return out[self._consumer_index(src, dst)]
        return out

    def _consumer_index(self, src: str, dst: str) -> int:
        return self.graph.dsts_of(src).index(dst)

    def _src_out(self, outputs: Dict[str, Any], src: str, dst: str):
        out = outputs[src]
        if isinstance(self.layers[src], SliceLayer):
            return out[self._consumer_index(src, dst)]
        return out

    def _fuse_relu_lrn(self) -> None:
        """Mark conv→relu→lrn chains for the fused relu+LRN kernels: the
        LRN layer reads the pre-relu tensor and applies the ReLU inside
        K5/K6 (LRNLayer.fuse_from).  The ReLU layer still produces its
        output for any other consumer."""
        for name in self.topo:
            layer = self.layers[name]
            if not isinstance(layer, LRNLayer) or \
                    len(layer.cfg.srclayers) != 1:
                continue
            src = self.layers[layer.cfg.srclayers[0]]
            if (isinstance(src, ReLULayer) and src.slope == 0.0
                    and len(src.cfg.srclayers) == 1
                    and not isinstance(self.layers[src.cfg.srclayers[0]],
                                       SliceLayer)):
                layer.fuse_from = src.cfg.srclayers[0]

    def _build_param_index(self) -> None:
        self.param_specs: Dict[str, ParamSpec] = {}
        self.param_aliases: Dict[str, str] = {}
        for name in self.topo:
            layer = self.layers[name]
            shared = list(layer.cfg.share_param)
            for i, spec in enumerate(layer.param_specs):
                if i < len(shared):
                    # share_param: this layer's i-th param aliases another
                    # layer's param, keyed "<layer>/<name>" of the owner
                    self.param_aliases[spec.name] = shared[i]
                else:
                    self.param_specs[spec.name] = spec

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int = 0, device: DeviceLike = None,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Fresh params from each spec's init method, drawn from one
        torch.Generator seeded with `seed` on `device` (CUDA unless the
        caller passes device='cpu')."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return {name: init_param(gen, spec.cfg, spec.shape, spec.fan_in,
                                 dtype)
                for name, spec in sorted(self.param_specs.items())}

    def multipliers(self) -> Dict[str, Multipliers]:
        """Each param's ParamProto learning_rate_multiplier and
        weight_decay_multiplier, for the updater."""
        return {name: Multipliers(spec.cfg.learning_rate_multiplier,
                                  spec.cfg.weight_decay_multiplier)
                for name, spec in self.param_specs.items()}

    def drawing_layers(self) -> Dict[int, str]:
        """Topological index → name of each layer whose training forward
        draws."""
        return {i: n for i, n in enumerate(self.topo)
                if self.layers[n].draws}

    def step_variant(self, step: int) -> Tuple:
        """What the training forward decides on the host from `step`, per
        layer that decides anything (`Layer.step_variant`)."""
        out = []
        for name in self.topo:
            v = self.layers[name].step_variant(step)
            if v is not None:
                out.append((name, v))
        return tuple(out)

    def _resolve_params(self, params: Dict[str, torch.Tensor]):
        full = dict(params)
        for alias, owner in self.param_aliases.items():
            if owner not in full:
                raise LayerError(f"share_param target {owner!r} not found")
            full[alias] = full[owner]
        return full

    # -- forward -----------------------------------------------------------
    def apply(self, params: Dict[str, torch.Tensor], batch: Dict[str, Any],
              train: Optional[bool] = None,
              compute_dtype: Optional[torch.dtype] = None,
              rng: Optional[int] = None, step: Optional[int] = None,
              generators: Optional[Dict[int, torch.Generator]] = None,
              layer_subset: Optional[List[str]] = None,
              shard: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         Dict[str, Any]]:
        """Run the net on the params' device.  Returns (total_loss,
        metrics, outputs): metrics gathers every loss layer's dict,
        outputs maps layer name → activation.  `batch` may hold numpy
        arrays; they are moved to the params' device.  `rng` (a seed) and
        `step` seed the generators of layers that draw; such a layer
        raises in training when `rng` is None.  `generators` (topological
        index → generator) replaces a drawing layer's own with the
        caller's, which the caller has seeded.  `layer_subset` runs only
        the named layers (in topological order; a prefix of the net, as
        the CD trainer's).  `shard` (index, n) marks `batch` as one of n
        slices of a global batch: layers that draw over the batch keep
        this slice's rows of the global draw.  A layer that leaves an
        auxiliary loss in `_aux` (kMoE) adds it to total_loss and to
        metrics as "<layer>/aux"."""
        if train is None:
            train = self.phase == "kTrain"
        full = self._resolve_params(params)
        dev = params_device(params)
        batch = _to_device(batch, dev)
        outputs: Dict[str, Any] = {}
        metrics: Dict[str, torch.Tensor] = {}
        total_loss = torch.zeros((), dtype=torch.float32, device=dev)
        n_loss = len(self._loss_layers())
        subset = None if layer_subset is None else set(layer_subset)
        for idx, name in enumerate(self.topo):
            if subset is not None and name not in subset:
                continue
            layer = self.layers[name]
            fuse_from = getattr(layer, "fuse_from", "")
            if fuse_from:
                srcs = [outputs[fuse_from]]
            else:
                srcs = [self._src_out(outputs, src, name)
                        for src in layer.cfg.srclayers]
            ctx = Context(batch=batch, train=train,
                          compute_dtype=compute_dtype, rng=rng,
                          layer_index=idx, step=step, device=dev,
                          generators=generators, shard=shard)
            out = layer.apply(full, srcs, ctx)
            outputs[name] = out
            aux = getattr(layer, "_aux", None)
            if aux is not None:
                # auxiliary losses (kMoE's router balance) join the
                # objective and the metric report
                total_loss = total_loss + aux
                metrics[f"{name}/aux"] = aux
            if layer.is_loss:
                total_loss = total_loss + out["loss"]
                for k, v in out.items():
                    metrics[k if n_loss == 1 else f"{name}/{k}"] = v
        return total_loss, metrics, outputs

    def _loss_layers(self) -> List[str]:
        return [n for n in self.topo if self.layers[n].is_loss]

    # -- introspection -----------------------------------------------------
    def to_json(self) -> str:
        """Net-structure dump for visualization (graph.cc:4-59)."""
        return self.graph.to_json()

    def debug_info(self, params: Dict[str, torch.Tensor],
                   outputs: Dict[str, Any],
                   grads: Optional[Dict[str, torch.Tensor]] = None) -> str:
        """Per-layer mean-absolute norms, the reference's DebugInfo
        printout (neuralnet.cc:350-378) under ModelProto.debug: each
        layer's output (but integer ones: token ids, labels), then each
        param, with its gradient's where `grads` has one.  Each mean is
        taken in its tensor's dtype, as the JAX package's `jnp.mean`."""
        lines = []
        for name in self.topo:
            out = outputs.get(name)
            if (isinstance(out, torch.Tensor)
                    and out.dtype not in (torch.int32, torch.int64)):
                lines.append(f"{name}: data {_mean_abs(out):.6f}")
        for pname, p in sorted(params.items()):
            line = f"{pname}: param {_mean_abs(p):.6f}"
            if grads is not None and pname in grads:
                line += f" grad {_mean_abs(grads[pname]):.6f}"
            lines.append(line)
        return "\n".join(lines)


def _mean_abs(t: torch.Tensor) -> float:
    t = t.detach()
    if not t.is_floating_point():
        t = t.float()
    return float(t.abs().mean())


def build_net(model_cfg: ModelConfig, phase: str = "kTrain",
              input_shapes=None, batchsize=None) -> NeuralNet:
    if model_cfg.neuralnet is None:
        raise LayerError("model config has no neuralnet section")
    return NeuralNet(model_cfg.neuralnet, phase, input_shapes, batchsize)
