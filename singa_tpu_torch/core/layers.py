"""Layer base of the port: the registry and the per-call context.

Port of `singa_tpu/core/layers.py:35-116` and `create_layer`
(`:602-613`).  A layer keeps the JAX package's two duties:

  setup(src_shapes)        shape inference + param spec declaration
  apply(params, srcs, ctx) forward compute on torch tensors

`params` is a plain dict keyed by the JAX names (`embed/embedding`,
`attn0/wq`, `ln_f/scale`, ...), so one weights dict fits both packages.
Only the sequence family (core/seq_layers.py) is ported so far; the
conv/vision zoo comes with its own slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config.schema import LayerConfig, ParamConfig


class LayerError(ValueError):
    pass


@dataclass
class ParamSpec:
    name: str           # global key: "<layer>/<param-name>"
    shape: Tuple[int, ...]
    fan_in: int
    cfg: ParamConfig


@dataclass
class Context:
    """Per-call state threaded through Layer.apply."""
    batch: Dict[str, Any]
    train: bool
    compute_dtype: Optional[torch.dtype] = None


LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(type_name: str):
    def deco(cls):
        LAYER_REGISTRY[type_name] = cls
        cls.type_name = type_name
        return cls
    return deco


class Layer:
    """Base layer. Subclasses fill out_shape and param_specs in setup()."""

    is_data = False     # True → reads from ctx.batch, has no srcs
    is_loss = False     # True → apply returns a metrics dict incl. "loss"

    def __init__(self, cfg: LayerConfig):
        self.cfg = cfg
        self.name = cfg.name
        self.out_shape: Any = None
        self.param_specs: List[ParamSpec] = []

    def setup(self, src_shapes: List[Any]) -> None:
        raise NotImplementedError

    def apply(self, params: Dict[str, torch.Tensor], srcs: List[Any],
              ctx: Context) -> Any:
        raise NotImplementedError

    def _param_cfg(self, i: int, default_name: str) -> ParamConfig:
        if i < len(self.cfg.param):
            return self.cfg.param[i]
        return ParamConfig(name=default_name)

    def _declare(self, i: int, default_name: str, shape,
                 fan_in: int) -> str:
        pcfg = self._param_cfg(i, default_name)
        key = f"{self.name}/{pcfg.name or default_name}"
        self.param_specs.append(ParamSpec(key, tuple(shape), fan_in, pcfg))
        return key


def create_layer(cfg: LayerConfig) -> Layer:
    if cfg.type not in LAYER_REGISTRY:
        from . import seq_layers  # noqa: F401  (registers on import)
    if cfg.type not in LAYER_REGISTRY:
        raise LayerError(f"unknown layer type {cfg.type!r} "
                         f"(registered: {sorted(LAYER_REGISTRY)})")
    return LAYER_REGISTRY[cfg.type](cfg)
