"""Autoregressive inference for the transformer LM: KV-cache prefill,
single-token decode, and sampling.

Port of `singa_tpu/models/generate.py:40-154`, `294-349` and `467-491`.
The JAX package compiles prefill plus a `lax.scan` decode into one
program; here the decode is a Python loop over eager PyTorch calls.
The same `NeuralNet` drives decode: position-wise layers run their
normal `apply`; only kAttention (cache write + read, absolute-position
RoPE) and the heads (emit logits instead of a loss) are special-cased.

The cache is updated in place (one (B, Hkv, max_len, D) buffer per
attention layer, written at [pos, pos + T)), where the JAX package
returns a new one; `forward_cached` still returns it so the call reads
the same on both sides.  Attention over the cache is a masked dense
read, so decode launches no K1: at one query token the score row is
tiny.  `beam_search` and the paged forms come with later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.layers import Context
from ..core.net import NeuralNet
from ..device import DeviceLike, params_device, params_dtype, resolve_device

CacheEntry = Dict[str, torch.Tensor]   # {"k","v"}: (B, Hkv, max_len, D)
Cache = Dict[str, CacheEntry]          # attention-layer name -> entry

_CTX = Context(batch={}, train=False)


def init_cache(net: NeuralNet, batchsize: int, max_len: int,
               dtype=torch.float32, device: DeviceLike = None) -> Cache:
    """Zeroed KV cache for every kAttention layer in the net, on
    `device` (CUDA unless the caller passes device='cpu')."""
    dev = resolve_device(device)
    cache: Cache = {}
    for name in net.topo:
        layer = net.layers[name]
        if layer.cfg.type != "kAttention":
            continue
        shape = (batchsize, layer.kv_heads, max_len, layer.head_dim)
        cache[name] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return cache


def _attn_cached(layer, params, x, entry: CacheEntry, pos: int,
                 kmask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, CacheEntry]:
    """Attention for a (B, T, E) chunk whose first token sits at absolute
    position `pos`, against the running KV cache.  `kmask` (B, max_len)
    bool marks attendable key positions (the serving tier's left-pad
    mask), ANDed with the causal mask.  GQA reads the cache at Hkv
    width: q is grouped to (B, Hkv, G, T, D), no expanded copy."""
    assert layer.causal, f"{layer.name}: decode requires causal attention"
    b, t, _ = x.shape
    positions = pos + torch.arange(t, device=x.device)
    q, k, v = layer.qkv(params, x, positions)
    entry["k"][:, :, pos:pos + t] = k.to(entry["k"].dtype)
    entry["v"][:, :, pos:pos + t] = v.to(entry["v"].dtype)

    groups = layer.heads // layer.kv_heads
    d = layer.head_dim
    kk = entry["k"].to(q.dtype)
    vv = entry["v"].to(q.dtype)
    kpos = torch.arange(kk.shape[2], device=x.device)[None, :]
    allowed = (kpos <= positions[:, None])[None]        # (1, T, max_len)
    if kmask is not None:
        allowed = allowed & kmask[:, None, :]           # (B, T, max_len)
    qg = q.reshape(b, layer.kv_heads, groups, t, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kk.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~allowed[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(vv.dtype), vv)
    out = out.reshape(b, layer.heads, t, d).transpose(1, 2).reshape(b, t, -1)
    return layer._proj(params, layer.wo, out.to(x.dtype)), entry


def forward_cached(net: NeuralNet, params, tokens, cache: Cache, pos: int,
                   kmask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Run the LM over a (B, T) token chunk at absolute offset `pos`.
    Returns (logits (B, T, V) float32, the cache, updated in place)."""
    full = net._resolve_params(params)
    tokens = torch.as_tensor(tokens, device=params_device(params)).long()
    outputs: Dict[str, Any] = {}
    new_cache: Cache = dict(cache)
    logits = None
    for name in net.topo:
        layer = net.layers[name]
        ltype = layer.cfg.type
        srcs = [outputs[s] for s in layer.cfg.srclayers]
        if ltype == "kSequenceData":
            outputs[name] = {"input": tokens, "target": tokens}
        elif ltype == "kSeqLabel":
            outputs[name] = tokens
        elif ltype == "kAttention":
            outputs[name], new_cache[name] = _attn_cached(
                layer, full, srcs[0], cache[name], pos, kmask=kmask)
        elif ltype == "kLMHead":
            logits = outputs[name] = layer.apply(full, srcs, _CTX)
        elif ltype == "kLMHeadLoss":
            # the fused loss layer's projection emits the logits
            logits = outputs[name] = layer.project_logits(full, srcs[0])
        else:
            outputs[name] = layer.apply(full, srcs, _CTX)
    if logits is None:
        raise ValueError("net has no kLMHead/kLMHeadLoss layer")
    return logits.float(), new_cache


def _sample(logits: torch.Tensor, gen: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64.  temperature 0 = greedy; otherwise
    top-k then nucleus truncation, then a Gumbel-max draw from `gen`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if 0.0 < top_p < 1.0:
        # keep a token iff the mass strictly before it is < top_p (the
        # top-1 token is always kept)
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kth = torch.where(before < top_p, desc,
                          torch.full_like(desc, math.inf)).amin(
                              dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, -1e30)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def decode(net: NeuralNet, params, prompt: torch.Tensor,
           max_new_tokens: int, gen: Optional[torch.Generator],
           temperature: float, top_k: int, top_p: float,
           eos_id: Optional[int], max_len: int,
           kmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill `prompt` (B, P) then sample `max_new_tokens` tokens one at
    a time; shared by `generate` and the engine's generate buckets.
    After `eos_id` a sequence keeps emitting `eos_id`."""
    b, p = prompt.shape
    cache = init_cache(net, b, max_len, params_dtype(params),
                       params_device(params))
    logits, cache = forward_cached(net, params, prompt, cache, 0, kmask)
    tok = _sample(logits[:, -1], gen, temperature, top_k, top_p)
    done = None if eos_id is None else tok == eos_id
    out = [tok]
    for i in range(1, max_new_tokens):
        logits, cache = forward_cached(net, params, tok[:, None], cache,
                                       p + i - 1, kmask)
        tok = _sample(logits[:, -1], gen, temperature, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


def generate(net: NeuralNet, params, prompt, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             eos_id: Optional[int] = None, max_len: Optional[int] = None,
             top_p: float = 0.0) -> torch.Tensor:
    """Sample `max_new_tokens` continuations of `prompt` ((B, P) ints) on
    the params' device.  Returns (B, max_new_tokens) int64.  Greedy when
    temperature == 0; top-k truncation when top_k > 0; nucleus when
    0 < top_p < 1 (top-k first).  `max_len` over-allocates the KV cache
    beyond prompt+new (the tail is masked).  `generator` plays the part
    of the JAX package's `key` (default: seed 0 on the params' device)."""
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    if int(max_new_tokens) <= 0:
        return torch.zeros((b, 0), dtype=torch.long, device=dev)
    if max_len is None:
        max_len = p + int(max_new_tokens)
    elif max_len < p + max_new_tokens:
        raise ValueError(f"max_len={max_len} < prompt({p}) + "
                         f"max_new_tokens({max_new_tokens})")
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return decode(net, params, prompt, int(max_new_tokens), generator,
                  float(temperature), int(top_k), float(top_p), eos_id,
                  int(max_len))
