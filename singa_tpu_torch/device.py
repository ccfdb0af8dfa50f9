"""Device policy of the port: CUDA unless the caller asks for the CPU.

Every entry point that places tensors (`NeuralNet.init_params`,
`weights.params_from_numpy`, `models.generate.init_cache`,
`serve.engine.InferenceEngine`) resolves its `device` argument here.
`None` means the card; a machine without one raises instead of running
the plain PyTorch path on the CPU behind the caller's back.  Functions
on tensors (`NeuralNet.apply`, `forward_cached`, `generate`, the op
wrappers) run where their inputs already are.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "singa_tpu_torch runs on CUDA unless told otherwise, and no "
            "CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of its kernels")
    return dev


def params_device(params) -> torch.device:
    """The device a params dict lives on (all entries share it)."""
    for v in params.values():
        return v.device
    raise ValueError("empty params dict")


def params_dtype(params) -> torch.dtype:
    """dtype of the first param in key order — the JAX package's
    `tree_leaves(params)[0].dtype` (dict leaves are key-sorted)."""
    return params[sorted(params)[0]].dtype
