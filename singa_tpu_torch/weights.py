"""Carrying weights and optimizer state into the port and back out.

`params_from_numpy` takes a `{name: ndarray}` dict — the JAX package's
params as numpy, or weights drawn with `numpy_params` — to the port's
params on a device.  Both packages key params by the same names and keep
the same layouts ((E, H·D) projections, the (V, E) embedding table), so
the move is one-to-one; it is checked name by name and shape by shape
against the port net's `param_specs`, and a missing, extra or misshaped
entry raises.  `opt_state_from_numpy` does the same for the optimizer
state, `{"history": {name: array}, "update": {...}}` in both packages,
and `state_to_numpy` takes the port's params and state back to numpy.
Over a model axis a rank holds shards: the JAX package's params as
numpy reach them through `params_from_numpy` and then
`parallel.partition.DataParallel.shard_params` (or `shard_params` of the
same module, for any rank of a mesh), which pad and slice as the JAX
package's `shard_params` places.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def params_from_numpy(net, arrays: Mapping[str, np.ndarray],
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """`arrays` as port params on `device` (CUDA unless the caller passes
    device='cpu'), in `dtype` (default: each array's own)."""
    dev = resolve_device(device)
    specs = net.param_specs
    missing = sorted(set(specs) - set(arrays))
    extra = sorted(set(arrays) - set(specs))
    if missing or extra:
        raise ValueError(f"weights do not match the net: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for name in sorted(specs):
        arr = np.asarray(arrays[name])
        if tuple(arr.shape) != tuple(specs[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the net "
                             f"declares {tuple(specs[name].shape)}")
        # a bfloat16 array the JAX package hands over (ml_dtypes' type,
        # which torch cannot read); a checkpoint's bf16 leaves come back
        # from utils/zarr.py already widened to float32
        if arr.dtype.name == "bfloat16":
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def opt_state_from_numpy(net, state: Mapping[str, Mapping[str, np.ndarray]],
                         device: DeviceLike = None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's `opt_state` as numpy — one dict of arrays per
    slot ("history", and "update" for kAdaDelta/kAdam) — as the port's,
    each slot checked against the net as `params_from_numpy` checks."""
    return {slot: params_from_numpy(net, arrays, device)
            for slot, arrays in state.items()}


def state_to_numpy(params: Mapping[str, torch.Tensor],
                   opt_state: Optional[Mapping[str, Mapping[str,
                                                          torch.Tensor]]]
                   = None):
    """(params, opt_state) as numpy dicts on the host, in the layout
    both packages share; opt_state None gives None."""
    def host(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}
    return (host(params),
            None if opt_state is None
            else {slot: host(d) for slot, d in opt_state.items()})


def numpy_params(net, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random float32 weights for `net` drawn with numpy from `seed`,
    from each spec's init method with the formulas of `core/init.py`
    (SINGA's Param::Init, param.cc:61-99); kPretrained raises, since
    such params are loaded, not drawn."""
    rng = np.random.default_rng(seed)
    return {name: _draw(rng, name, spec.cfg, tuple(spec.shape), spec.fan_in)
            for name, spec in sorted(net.param_specs.items())}


def _draw(rng, name, cfg, shape, fan_in) -> np.ndarray:
    method, value = cfg.init_method, cfg.value

    def uniform(low, high):
        return rng.uniform(low, high, shape).astype(np.float32)

    def gaussian():
        return (cfg.mean + cfg.std * rng.standard_normal(
            shape, dtype=np.float32)).astype(np.float32)

    # the reference scales by `value` only when it is nonzero
    if method == "kConstant":
        x = np.full(shape, value, np.float32)
    elif method == "kUniform":
        x = uniform(cfg.low, cfg.high) * (value or 1.0)
    elif method == "kUniformSqrtFanIn":
        x = uniform(cfg.low, cfg.high) * (
            value / math.sqrt(fan_in / 3.0) if value else 1.0)
    elif method == "kUniformSqrtFanInOut":
        x = uniform(cfg.low, cfg.high) * (
            value / math.sqrt(shape[0] + shape[1]) if value else 1.0)
    elif method == "kGaussain":
        x = gaussian() * (value or 1.0)
    elif method == "kGaussainSqrtFanIn":
        x = gaussian() * (value / math.sqrt(shape[0]) if value else 1.0)
    elif method == "kXavier":
        limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
        x = uniform(-limit, limit)
    elif method == "kMSRA":
        x = math.sqrt(2.0 / max(fan_in, 1)) * rng.standard_normal(
            shape, dtype=np.float32)
    elif method == "kPretrained":
        raise ValueError(f"{name}: kPretrained params are loaded, not "
                         f"drawn (see utils.checkpoint.load_pretrained)")
    else:
        raise ValueError(f"{name}: unknown init_method {method!r}")
    return np.asarray(x, np.float32)
