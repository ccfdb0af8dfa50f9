"""Plain PyTorch reference of a Mistral-style decoder LM.

Written from the published description (Mistral-7B's `config.json` and
the Mistral architecture): token embedding; per block a pre-RMSNorm
grouped-query attention with rotary embeddings (rotate-half layout,
frequencies theta^(-2i/D)) and causal masking, and a pre-RMSNorm SwiGLU
FFN, each added to the residual; a final RMSNorm and an untied head;
mean next-token cross entropy.  Departure: Mistral's 4096-token sliding
window is not applied, which computes the same function on sequences of
at most 4096 tokens, the only ones the benchmark runs.

Every tensor is float32 and every product runs through
`precision.mm` in the mode asked for.  No kernel, cache or batching
trick: attention materialises its (H, S, S) scores.  Param names and
layouts are the benchmark's convention for handing one set of weights
to both sides (`param_shapes`); this module imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import mm


def dims(cfg: Dict) -> Dict[str, int]:
    e, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"E": e, "H": h, "Hkv": cfg["num_key_value_heads"],
            "D": cfg.get("head_dim") or cfg["assumed"].get("head_dim")
            or e // h,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def param_shapes(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, value) of every param: init "normal" draws
    N(0, value), "constant" fills value."""
    m = dims(cfg)
    e, hd, kvd, f, v = (m["E"], m["H"] * m["D"], m["Hkv"] * m["D"], m["F"],
                        m["V"])
    std = cfg["initializer_range"]
    out = [("embed/embedding", (v, e), "normal", std)]
    for i in range(m["L"]):
        out += [(f"ln{i}a/scale", (e,), "constant", 1.0),
                (f"attn{i}/wq", (e, hd), "normal", std),
                (f"attn{i}/wk", (e, kvd), "normal", std),
                (f"attn{i}/wv", (e, kvd), "normal", std),
                (f"attn{i}/wo", (hd, e), "normal", std),
                (f"ln{i}b/scale", (e,), "constant", 1.0),
                (f"ffn{i}/w1", (e, f), "normal", std),
                (f"ffn{i}/w2", (f, e), "normal", std),
                (f"ffn{i}/w3", (e, f), "normal", std)]
    out += [("ln_f/scale", (e,), "constant", 1.0),
            ("loss/w", (e, v), "normal", std)]
    return out


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """x (B, H, S, D): rotate-half rotary embedding."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float64,
                                    device=x.device) / (d // 2))
    ang = positions.double()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(cfg: Dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
           mode: str = "f32") -> torch.Tensor:
    """(B, S, V) float32 next-token logits of (B, S) `tokens`."""
    m = dims(cfg)
    h_, hkv, d = m["H"], m["Hkv"], m["D"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    x = w["embed/embedding"][tokens.long()].float()
    for i in range(m["L"]):
        h = _rmsnorm(x, w[f"ln{i}a/scale"], eps)
        q = mm(h, w[f"attn{i}/wq"], mode).view(b, s, h_, d).transpose(1, 2)
        k = mm(h, w[f"attn{i}/wk"], mode).view(b, s, hkv, d).transpose(1, 2)
        v = mm(h, w[f"attn{i}/wv"], mode).view(b, s, hkv, d).transpose(1, 2)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        k = k.repeat_interleave(h_ // hkv, dim=1)
        v = v.repeat_interleave(h_ // hkv, dim=1)
        scores = mm(q, k.transpose(-1, -2), mode) / math.sqrt(d)
        scores = scores.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(scores, dim=-1), v, mode)
        o = o.transpose(1, 2).reshape(b, s, h_ * d)
        x = x + mm(o, w[f"attn{i}/wo"], mode)
        h = _rmsnorm(x, w[f"ln{i}b/scale"], eps)
        g = F.silu(mm(h, w[f"ffn{i}/w1"], mode)) * mm(h, w[f"ffn{i}/w3"],
                                                      mode)
        x = x + mm(g, w[f"ffn{i}/w2"], mode)
    h = _rmsnorm(x, w["ln_f/scale"], eps)
    return mm(h, w["loss/w"], mode)


def loss_and_grads(cfg: Dict, w: Dict[str, torch.Tensor],
                   inputs: torch.Tensor, targets: torch.Tensor,
                   mode: str = "f32", rows: int = 1
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean cross entropy over every token of (B, S) `inputs` and the
    gradient of every param, `rows` rows of the batch at a time (the
    gradients of the blocks summed, so the result is the whole batch's)."""
    names = list(w)
    leaves = [w[k].detach().requires_grad_(True) for k in names]
    wl = dict(zip(names, leaves))
    total = inputs.numel()
    loss_sum = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for lo in range(0, inputs.shape[0], rows):
        lg = logits(cfg, wl, inputs[lo:lo + rows], mode)
        part = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               targets[lo:lo + rows].reshape(-1).long(),
                               reduction="sum")
        gs = torch.autograd.grad(part / total, leaves, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        loss_sum += float(part.detach())
        del lg, part, gs
    return loss_sum / total, dict(zip(names, grads))
