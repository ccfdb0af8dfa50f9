"""FLOP accounting and MFU (model FLOPs utilization) on the card.

Port of `singa_tpu/utils/flops.py`.  MFU is achieved model FLOP/s over
the card's peak, so this module has two FLOP sources:

  * `net_forward_flops(net)` / `net_train_flops(net)`: the analytic
    count (2·MACs) walked over the net's conv, linear, attention, FFN,
    kMoE and LM-head layers, with the JAX package's conventions: causal
    attention scores halved, kMoE counted at its routed budget, a train
    step 3x the forward.  Device-independent, and equal to the JAX
    package's integers on every config.
  * `counted_flops(fn, *args)`: one eager call of `fn` under
    `torch.utils.flop_counter.FlopCounterMode`, the counterpart of the
    JAX package's `compiled_flops` (XLA's cost analysis), which a CUDA
    graph does not have.  The kernels the port launches through ctypes
    (K1-K6, `ops/_kernels.py`) pass no aten op, so the counter never
    sees their products: the same blind spot XLA's cost analysis has
    for a Pallas call.  A program that runs K1-K6 (the train and eval
    steps) therefore takes its MFU from the analytic count; the counted
    one serves programs that run none of them (the serving graphs).

XLA's cost analysis also reports the bytes a program accesses, from
which the JAX package derives `singa_program_bytes` and an arithmetic
intensity.  Nothing in PyTorch counts the bytes a CUDA graph moves, so
the port reports FLOPs only.

MFU convention (the JAX package's): model FLOPs per step divided by
(step seconds · the card's dense bf16 tensor-core peak), whatever dtype
the program computes in.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense bf16 tensor-core peak FLOP/s, keyed by torch.cuda.get_device_name
# (NVIDIA's H100 data sheet, without sparsity)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,    # SXM5
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops(device=None) -> Optional[float]:
    """The card's dense bf16 peak for `device` (a CUDA device, index or
    name; default: the current card); None for the CPU, without a card,
    or for a card the table does not know."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


def mfu(model_flops: float, step_seconds: float,
        device=None) -> Optional[float]:
    """model_flops per step / (step_seconds · peak); None when the peak
    is unknown."""
    peak = peak_flops(device)
    if not peak or step_seconds <= 0:
        return None
    return model_flops / (step_seconds * peak)


def counted_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one eager call `fn(*args, **kwargs)`, counted by
    `FlopCounterMode` over the aten ops it dispatches (products and
    convolutions, 2·MACs); None when it counted nothing.  The call runs
    for real: its writes and draws happen."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


# -- analytic per-layer counts (forward, 2·MACs convention) ----------------

def _conv_flops(layer) -> int:
    n, h, w, c_out = layer.out_shape  # NHWC
    return 2 * n * c_out * h * w * layer.kernel ** 2 * layer.channels


def _linear_flops(layer) -> int:
    n, out = layer.out_shape
    vdim, hdim = layer.param_specs[0].shape  # weight (vdim, hdim)
    return 2 * n * vdim * hdim


def _attention_flops(layer) -> int:
    b, s, e = layer.out_shape
    hd = layer.heads * layer.head_dim
    kvd = layer.kv_heads * layer.head_dim
    proj = 2 * b * s * e * (hd + 2 * kvd + hd)        # wq wk wv wo
    scores = 4 * b * layer.heads * s * s * layer.head_dim   # qk + pv
    if layer.causal:
        # the causal-half convention (about half the score matrix is
        # live); the dense route computes all of it and the flash
        # kernels' diagonal tiles are whole tiles
        scores //= 2
    return proj + scores


def _ffn_flops(layer) -> int:
    b, s, e = layer.out_shape
    f = layer.param_specs[0].shape[1]                 # w1 (E, F)
    mats = 3 if getattr(layer, "gated", False) else 2
    return 2 * b * s * e * f * mats


def _moe_flops(layer) -> int:
    b, s, e = layer.out_shape
    f = layer.param_specs[1].shape[2]                 # w1 (n_exp, E, F)
    router = 2 * b * s * e * layer.n_exp
    # each token runs k experts' (E→F→E) MLP; capacity drops depend on
    # the data, so the routed budget is counted
    return router + 2 * b * s * layer.k * 2 * e * f


def _lm_head_flops(layer) -> int:
    if layer.cfg.type == "kLMHeadLoss":
        b, s, e, v = layer.flops_shape
    else:
        b, s, v = layer.out_shape
        e = layer.param_specs[0].shape[0]       # w (E, V), tied or not
    return 2 * b * s * e * v


def layer_forward_flops(layer) -> int:
    """Product and convolution FLOPs of one layer's forward; 0 for the
    elementwise, pooling, LRN and norm layers."""
    t = layer.cfg.type
    if t == "kConvolution":
        return _conv_flops(layer)
    if t == "kInnerProduct":
        return _linear_flops(layer)
    if t == "kAttention":
        return _attention_flops(layer)
    if t == "kFeedForward":
        return _ffn_flops(layer)
    if t == "kMoE":
        return _moe_flops(layer)
    if t in ("kLMHead", "kLMHeadLoss"):
        return _lm_head_flops(layer)
    return 0


def net_forward_flops(net) -> int:
    """Analytic forward model FLOPs of a built NeuralNet."""
    return sum(layer_forward_flops(net.layers[name]) for name in net.topo)


def net_train_flops(net) -> int:
    """Train-step model FLOPs: the backward does each product twice
    (input and weight gradients), so 3x the forward, the convention
    published MFU figures use (it counts 3x for the first trainable
    layer too, whose input gradient nothing computes)."""
    return 3 * net_forward_flops(net)
