"""Plain PyTorch reference of a SINGA vision net from its layer list.

Follows SINGA's layer semantics as the configuration file states them
(`unset_fields` there gives what the proto supplies for a field the conf
leaves unset): kRGBImage scales (and, in training, mirrors the images
whose coin came up); kConvolution is a cross-correlation with zero
padding and a (num_filters, C·k·k) weight in OIHW order plus a bias;
kReLU; kLRN normalises across channels, y = a·(k + alpha/n·Σ a²)^-beta
over a window of n channels centred on each; kPooling takes the max
over caffe's ceil-mode geometry (windows reaching past the bottom and
right edges are clipped); kInnerProduct flattens the NHWC activation in
(H, W, C) order and multiplies by a (vdim, hdim) weight plus a bias;
kDropout multiplies by mask / (1 - ratio); kSoftmaxLoss is the mean
cross entropy.  Activations run NCHW in float32; every product and
convolution runs in the precision mode asked for.  Imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import operand


def param_shapes(cfg: Dict, batch: int) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, value) of every param in layer order."""
    from ..counts.flops import vision_shapes
    unset = cfg["unset_fields"]
    layers = {l["name"]: l for l in cfg["model"]["neuralnet"]["layer"]}
    c, _, _ = cfg["input"]["pixel"]
    shapes = {r["name"]: r["shape"] for r in vision_shapes(cfg, batch)}
    out = []
    prev_shape = {"data": (batch,) + tuple(cfg["input"]["pixel"][1:]) + (c,)}
    for name, layer in layers.items():
        t = layer["type"]
        src = layer.get("srclayers")
        src = src[0] if isinstance(src, list) else src
        ins = shapes.get(src, prev_shape.get(src))
        if t == "kConvolution":
            p = layer["convolution_param"]
            fan = ins[-1] * p["kernel"] ** 2
            wshape, bshape = (p["num_filters"], fan), (p["num_filters"],)
        elif t == "kInnerProduct":
            vdim = int(math.prod(ins[1:]))
            n = layer["inner_product_param"]["num_output"]
            wshape, bshape = (vdim, n), (n,)
        else:
            continue
        wp, bp = layer["param"]
        out.append((f"{name}/weight", wshape, "normal", wp["std"]))
        out.append((f"{name}/bias", bshape, "constant",
                    bp.get("value", unset["param_value"])))
    return out


def multipliers(cfg: Dict) -> Dict[str, Tuple[float, float]]:
    """param name -> (learning-rate, weight-decay) multiplier."""
    unset = cfg["unset_fields"]
    out = {}
    for layer in cfg["model"]["neuralnet"]["layer"]:
        for p in layer.get("param", []):
            out[f"{layer['name']}/{p['name']}"] = (
                p.get("learning_rate_multiplier",
                      unset["learning_rate_multiplier"]),
                p.get("weight_decay_multiplier",
                      unset["weight_decay_multiplier"]))
    return out


def _lrn(a, size, alpha, beta, knorm):
    """Across channels of NCHW `a`."""
    sq = F.pad((a * a).unsqueeze(1), (0, 0, 0, 0, size // 2, size // 2))
    s = F.avg_pool3d(sq, (size, 1, 1), stride=1).squeeze(1) * size
    return a * (s * (alpha / size) + knorm) ** -beta


def _maxpool(x, k, s):
    h, w = x.shape[2], x.shape[3]
    oh, ow = (int(math.ceil((h - k) / s)) + 1, int(math.ceil((w - k) / s))
              + 1)
    ph, pw = max(0, (oh - 1) * s + k - h), max(0, (ow - 1) * s + k - w)
    x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def loss(cfg: Dict, w: Dict[str, torch.Tensor], pixels: torch.Tensor,
         labels: torch.Tensor, mode: str = "f32",
         flips: Optional[torch.Tensor] = None,
         masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Mean cross entropy of (B, C, H, W) `pixels`.  `flips` (B,) bool
    mirrors images (training), `masks` maps each kDropout layer to its
    (B, n) keep mask (training); None runs the net as in evaluation."""
    unset = cfg["unset_fields"]
    out: Dict[str, torch.Tensor] = {}
    for layer in cfg["model"]["neuralnet"]["layer"]:
        t, name = layer["type"], layer["name"]
        src = layer.get("srclayers")
        src = src[0] if isinstance(src, list) else src
        x = out.get(src)
        if t == "kShardData" or t == "kLabel":
            continue
        if t == "kRGBImage":
            y = pixels.float()
            if flips is not None and layer["rgbimage_param"].get("mirror"):
                y = torch.where(flips[:, None, None, None], y.flip(-1), y)
            y = y * layer["rgbimage_param"].get("scale", 1.0)
        elif t == "kConvolution":
            p = layer["convolution_param"]
            k, f = p["kernel"], p["num_filters"]
            wk = w[f"{name}/weight"].reshape(f, x.shape[1], k, k)
            y = F.conv2d(operand(x, mode), operand(wk, mode), None,
                         p.get("stride", unset["convolution_stride"]),
                         p.get("pad", 0))
            y = y + w[f"{name}/bias"].reshape(1, f, 1, 1)
        elif t == "kReLU":
            y = torch.relu(x)
        elif t == "kLRN":
            p = {**unset["lrn"], **layer.get("lrn_param", {})}
            y = _lrn(x, p["local_size"], p["alpha"], p["beta"], p["knorm"])
        elif t == "kPooling":
            p = layer["pooling_param"]
            if p.get("pool", unset["pool"]) != "MAX":
                raise ValueError(f"{name}: only MAX pooling is written here")
            y = _maxpool(x, p["kernel"], p["stride"])
        elif t == "kInnerProduct":
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) \
                if x.dim() == 4 else x
            y = torch.matmul(operand(flat, mode),
                             operand(w[f"{name}/weight"], mode))
            y = y + w[f"{name}/bias"]
        elif t == "kDropout":
            ratio = layer.get("dropout_param", {}).get(
                "dropout_ratio", unset["dropout_ratio"])
            y = x if masks is None else x * masks[name].float() / (1 - ratio)
        elif t == "kSoftmaxLoss":
            scale = layer.get("softmaxloss_param", {}).get(
                "scale", unset["softmaxloss_scale"])
            return F.cross_entropy(x * scale, labels.long())
        else:
            raise ValueError(f"{name}: layer type {t} is not written here")
        out[name] = y
    raise ValueError("the layer list has no kSoftmaxLoss")


def loss_and_grads(cfg, w, pixels, labels, mode="f32", flips=None,
                   masks=None) -> Tuple[float, Dict[str, torch.Tensor]]:
    names = list(w)
    leaves = [w[k].detach().requires_grad_(True) for k in names]
    value = loss(cfg, dict(zip(names, leaves)), pixels, labels, mode, flips,
                 masks)
    grads = torch.autograd.grad(value, leaves)
    return float(value.detach()), dict(zip(names, grads))
