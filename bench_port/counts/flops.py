"""The benchmark's own FLOP, byte and peak arithmetic.

Frozen copies of the conventions of the port's `utils/flops.py`
(`net_forward_flops`, `net_train_flops`, `PEAK_FLOPS`): 2 FLOPs a
multiply-add, causal attention scores halved, a train step 3x the
forward.  They are computed here from a configuration file, never from
the program's own count, so a change to the program cannot move the
yardstick.  Kernel operations and bytes follow the roofline rule: each
input byte read once, each output byte written once, the operations
these shapes need.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

# dense bf16 tensor-core peak FLOP/s and HBM bytes/s, keyed by
# torch.cuda.get_device_name (NVIDIA's H100 data sheet, without sparsity)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 PCIe": 756e12}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H100 PCIe": 2.0e12}


def peaks(kind: str) -> Optional[tuple]:
    """(FLOP/s, bytes/s) of the card named `kind`, or None."""
    if kind in PEAK_FLOPS:
        return PEAK_FLOPS[kind], PEAK_BYTES[kind]
    return None


# -- the LM (a Mistral-style decoder) ---------------------------------------

def lm_dims(cfg: Dict) -> Dict[str, int]:
    e, h = cfg["hidden_size"], cfg["num_attention_heads"]
    d = cfg.get("head_dim") or cfg["assumed"].get("head_dim") or e // h
    return {"E": e, "H": h, "Hkv": cfg["num_key_value_heads"], "D": d,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def lm_layer_matmul_flops_per_token(cfg: Dict) -> int:
    """One block's projection and FFN FLOPs per token (no scores)."""
    m = lm_dims(cfg)
    hd, kvd = m["H"] * m["D"], m["Hkv"] * m["D"]
    proj = 2 * m["E"] * (hd + 2 * kvd + hd)         # wq wk wv wo
    ffn = 2 * m["E"] * m["F"] * 3                   # w1 w3 w2 (SwiGLU)
    return proj + ffn


def lm_scores_flops(cfg: Dict, b: int, s: int) -> int:
    """QK^T and PV of one block over (b, s), causal half."""
    m = lm_dims(cfg)
    return 4 * b * m["H"] * s * s * m["D"] // 2


def lm_forward_flops(cfg: Dict, b: int, s: int) -> int:
    """Forward model FLOPs of a (b, s) batch: blocks and the head."""
    m = lm_dims(cfg)
    t = b * s
    blocks = m["L"] * (t * lm_layer_matmul_flops_per_token(cfg)
                       + lm_scores_flops(cfg, b, s))
    return blocks + 2 * t * m["E"] * m["V"]


def lm_train_flops(cfg: Dict, b: int, s: int) -> int:
    return 3 * lm_forward_flops(cfg, b, s)


def lm_prefill_flops(cfg: Dict, plen: int) -> int:
    """Forward FLOPs of one prompt of `plen` tokens, logits of every
    position included (the convention of the count above)."""
    return lm_forward_flops(cfg, 1, plen)


def lm_decode_flops(cfg: Dict, ctx: int) -> int:
    """Forward FLOPs of one decoded token attending over `ctx` positions
    (itself included): the products, QK^T and PV over ctx, the head."""
    m = lm_dims(cfg)
    scores = 4 * m["H"] * ctx * m["D"]
    return (m["L"] * (lm_layer_matmul_flops_per_token(cfg) + scores)
            + 2 * m["E"] * m["V"])


# -- attention kernels K1 (forward), K3 (dQ), K4 (dK, dV) -------------------

def attention_kernel_work(kernel: str, b: int, s: int, h: int, hkv: int,
                          d: int, elem: int = 2) -> tuple:
    """(operations, bytes) one causal launch over packed (b, s, h·d)
    needs.  K1 computes S = QK^T and O = PV; K3 recomputes S and forms
    dP = dO V^T and dQ = dS K; K4 recomputes S and forms dV = P^T dO,
    dP and dK = dS^T Q.  Each product is 2·s·s·d a head, halved by the
    causal mask.  lse and delta are f32 (b, s, h)."""
    pair = 2 * b * h * s * s * d // 2
    q = b * s * h * d * elem
    kv = b * s * hkv * d * elem
    rows = b * s * h * 4
    if kernel == "flash_fwd":
        return 2 * pair, q + 2 * kv + q + rows              # q k v -> o lse
    if kernel == "flash_dq":
        return 3 * pair, q + 2 * kv + q + 2 * rows + q       # q k v do lse delta -> dq
    if kernel == "flash_dkv":
        return 4 * pair, q + 2 * kv + q + 2 * rows + 2 * kv  # -> dk dv
    raise ValueError(f"unknown attention kernel {kernel!r}")


# -- the vision net (a SINGA layer list) ------------------------------------

def _pooled(size: int, k: int, s: int) -> int:
    return int(math.ceil((size - k) / s)) + 1


def vision_shapes(cfg: Dict, batch: int) -> List[Dict]:
    """Walk the layer list once: for each layer its type, output shape
    (NHWC or (B, n)) and, for a conv or an inner product, the product
    dims."""
    c, hh, ww = cfg["input"]["pixel"]
    shape = (batch, hh, ww, c)
    out: Dict[str, tuple] = {}
    rows = []
    for layer in cfg["model"]["neuralnet"]["layer"]:
        t, name = layer["type"], layer["name"]
        src = layer.get("srclayers")
        src = src[0] if isinstance(src, list) else src
        ins = out.get(src, shape)
        row = {"name": name, "type": t}
        if t == "kConvolution":
            p = layer["convolution_param"]
            k, pad, f = p["kernel"], p.get("pad", 0), p["num_filters"]
            st = p.get("stride", 1)
            n, h, w, ci = ins
            ho, wo = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
            out[name] = (n, ho, wo, f)
            row["flops"] = 2 * n * f * ho * wo * k * k * ci
        elif t == "kPooling":
            p = layer["pooling_param"]
            n, h, w, ci = ins
            out[name] = (n, _pooled(h, p["kernel"], p["stride"]),
                         _pooled(w, p["kernel"], p["stride"]), ci)
        elif t == "kInnerProduct":
            n = ins[0]
            vdim = int(math.prod(ins[1:]))
            hdim = layer["inner_product_param"]["num_output"]
            out[name] = (n, hdim)
            row["flops"] = 2 * n * vdim * hdim
        elif t in ("kShardData", "kLabel", "kSoftmaxLoss"):
            out[name] = ins
        else:
            out[name] = ins
        row["shape"] = out[name]
        rows.append(row)
    return rows


def vision_forward_flops(cfg: Dict, batch: int) -> int:
    return sum(r.get("flops", 0) for r in vision_shapes(cfg, batch))


def vision_train_flops(cfg: Dict, batch: int) -> int:
    return 3 * vision_forward_flops(cfg, batch)


def lrn_kernel_bytes(kernel: str, shape: tuple, elem: int = 2) -> int:
    """K5 reads x and writes y; K6 reads x and g and writes dx."""
    n = int(math.prod(shape)) * elem
    if kernel == "lrn_fwd":
        return 2 * n
    if kernel == "lrn_bwd":
        return 3 * n
    raise ValueError(f"unknown LRN kernel {kernel!r}")


def lrn_shapes(cfg: Dict, batch: int) -> List[tuple]:
    """The NHWC input shape of every kLRN layer."""
    return [r["shape"] for r in vision_shapes(cfg, batch)
            if r["type"] == "kLRN"]
