"""Autoregressive inference for the transformer LM: KV-cache prefill,
single-token decode, the paged forms continuous batching runs on, and
sampling.

Port of `singa_tpu/models/generate.py:40-291`, `294-349`, `352-464`
(`beam_search`) and `467-491`.  The JAX package compiles prefill plus a
`lax.scan` decode into one program; here `decode` is a Python loop with
every position a host constant, so the serving engine captures the
whole loop, unrolled, as one CUDA graph per bucket.  The same `NeuralNet` drives decode:
position-wise layers run their normal `apply`; only kAttention (cache
write + read, absolute-position RoPE) and the heads (emit logits
instead of a loss; kSoftmaxLoss is skipped) are special-cased.

Caches and paged pools are updated in place (`index_put_`), where the
JAX package returns new ones from donated buffers; `forward_cached`,
`forward_paged` and `scatter_prefill` still return them, so call sites
read the same on both sides.  Token inputs are tensors already on the
params' device: a copy from host memory cannot be captured into a
graph, so callers convert before the call.  Attention over a cache is a
masked dense read, so decode launches no K1: at one query token the
score row is tiny.  `beam_search` runs eagerly, on tensors only (every
position a host constant, no value read back), and ranks candidates
with `ops.topk.top_k`, whose ties keep the lowest index first as
`jax.lax.top_k` does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.layers import Context
from ..core.net import NeuralNet
from ..device import DeviceLike, params_device, params_dtype, resolve_device
from ..ops.topk import top_k

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


def _forward_lm(net: NeuralNet, params, tokens: torch.Tensor,
                attend) -> torch.Tensor:
    """The LM over a (B, T) token tensor, with `attend(layer, full, x)`
    standing in for every kAttention layer.  Returns (B, T, V) float32
    logits; kSoftmaxLoss is skipped (no loss at decode)."""
    if not isinstance(tokens, torch.Tensor):
        raise TypeError("tokens must be a tensor on the params' device "
                        "(a host copy inside the call could not be "
                        "captured into a CUDA graph)")
    full = net._resolve_params(params)
    tokens = tokens.long()
    outputs: Dict[str, Any] = {}
    logits = None
    for name in net.topo:
        layer = net.layers[name]
        ltype = layer.cfg.type
        srcs = [net._src_out(outputs, s, name) for s in layer.cfg.srclayers]
        if ltype == "kSequenceData":
            outputs[name] = {"input": tokens, "target": tokens}
        elif ltype == "kSeqLabel":
            outputs[name] = tokens
        elif ltype == "kAttention":
            outputs[name] = attend(layer, full, srcs[0])
        elif ltype == "kLMHead":
            logits = outputs[name] = layer.apply(full, srcs, _CTX)
        elif ltype == "kLMHeadLoss":
            # the fused loss layer's projection emits the logits
            logits = outputs[name] = layer.project_logits(full, srcs[0])
        elif ltype == "kSoftmaxLoss":
            outputs[name] = None     # no loss at decode
        else:
            outputs[name] = layer.apply(full, srcs, _CTX)
    if logits is None:
        raise ValueError("net has no kLMHead/kLMHeadLoss layer")
    return logits.float()


def forward_cached(net: NeuralNet, params, tokens: torch.Tensor,
                   cache: Cache, pos: int,
                   kmask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Run the LM over a (B, T) token tensor at absolute offset `pos`.
    Returns (logits (B, T, V) float32, the cache, updated in place)."""
    logits = _forward_lm(
        net, params, tokens,
        lambda layer, full, x: _attn_cached(layer, full, x, cache[layer.name],
                                            pos, kmask=kmask)[0])
    return logits, dict(cache)


def _attn_paged(layer, params, x, entry: CacheEntry, tables: torch.Tensor,
                ntoks: torch.Tensor) -> Tuple[torch.Tensor, CacheEntry]:
    """Single-token decode attention over a block/paged KV pool.

    `x` is (1, S, E): the S decode slots ride the sequence axis of a
    batch-1 chunk, so every position-wise layer and `layer.qkv`'s RoPE
    treat a slot like a sequence position; `ntoks` (S,) is both the
    per-slot absolute position RoPE rotates by and the per-slot
    key-visibility horizon.  `entry` holds the layer's (num_blocks,
    Hkv, block_len, D) pools; `tables` (S, T) maps slot s's logical
    block t to a pool block (block 0 is the null block: inactive slots
    and table tails point there, and no mask ever reads it).  Token
    position p of slot s lives at pool[tables[s, p // bl], :, p % bl].

    Write before read: the new K/V lands at position ntoks[s] first
    (in place; inactive slots all write the null block, where duplicate
    writes are harmless), then the gather reads `kpos <= ntoks[s]`, the
    self-inclusive causal horizon of `_attn_cached` at T=1."""
    assert layer.causal, f"{layer.name}: decode requires causal attention"
    _, s, _ = x.shape
    hkv, d = layer.kv_heads, layer.head_dim
    bl = entry["k"].shape[2]
    q, k, v = layer.qkv(params, x, ntoks)       # (1,H,S,D), (1,Hkv,S,D)
    bidx = tables[torch.arange(s, device=x.device), ntoks // bl]
    off = ntoks % bl
    # advanced indices (S,) around the ":" take an (S, Hkv, D) update
    entry["k"][bidx, :, off] = k[0].transpose(0, 1).to(entry["k"].dtype)
    entry["v"][bidx, :, off] = v[0].transpose(0, 1).to(entry["v"].dtype)

    t = tables.shape[1]
    # (S, T, Hkv, bl, D) -> (S, Hkv, T*bl, D): flat position = absolute
    kk = entry["k"][tables].transpose(1, 2).reshape(s, hkv, t * bl, d)
    vv = entry["v"][tables].transpose(1, 2).reshape(s, hkv, t * bl, d)
    kk, vv = kk.to(q.dtype), vv.to(q.dtype)
    groups = layer.heads // hkv
    qg = q[0].transpose(0, 1).reshape(s, hkv, groups, 1, d)
    kpos = torch.arange(t * bl, device=x.device)[None, :]
    allowed = kpos <= ntoks[:, None]                # (S, T*bl)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kk.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~allowed[:, None, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(vv.dtype), vv)
    out = out.reshape(1, s, layer.heads * d)        # back to (1, S, H*D)
    return layer._proj(params, layer.wo, out.to(x.dtype)), entry


def forward_paged(net: NeuralNet, params, tokens: torch.Tensor,
                  pools: Cache, tables: torch.Tensor, ntoks: torch.Tensor
                  ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for S slots against the paged KV pools.
    `tokens` (1, S): slot s's last sampled token on the sequence axis;
    `tables` (S, T) block tables; `ntoks` (S,) tokens already written
    per slot (the incoming token's absolute position).  All three are
    tensors on the params' device.  Returns (logits (1, S, V) float32,
    the pools, written in place)."""
    tables, ntoks = tables.long(), ntoks.long()
    logits = _forward_lm(
        net, params, tokens,
        lambda layer, full, x: _attn_paged(layer, full, x, pools[layer.name],
                                           tables, ntoks)[0])
    return logits, pools


def scatter_prefill(pools: Cache, cache: Cache,
                    table_row: torch.Tensor) -> Cache:
    """Scatter a batch-1 contiguous prefill cache ((1, Hkv, P, D) per
    layer, P a block_len multiple) into the paged pools, in place, at
    the blocks named by `table_row` (P // block_len,).  Table entries
    beyond the slot's real reservation are 0: garbage from pad
    positions lands in the null block, where no mask ever looks."""
    row = table_row.long()
    for name, entry in cache.items():
        for side in ("k", "v"):
            pool = pools[name][side]
            _, hkv, p, d = entry[side].shape
            bl = pool.shape[2]
            blocks = entry[side][0].reshape(hkv, p // bl, bl, d)
            pool[row] = blocks.transpose(0, 1).to(pool.dtype)
    return pools


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


def beam_search(net: NeuralNet, params, prompt, max_new_tokens: int,
                num_beams: int = 4, length_penalty: float = 0.0,
                eos_id: Optional[int] = None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode on the params' device: returns (tokens (B,
    max_new_tokens) int64, log-prob scores (B,) float32) of the best beam
    per sequence.  The prefill runs at batch B, then the decode at
    B·num_beams with beam varying fastest (flat row b·W + j is batch b's
    beam j), the KV cache reordered every step.  After `eos_id` a beam
    is frozen: it keeps emitting eos at zero added cost and its score
    stops moving.  `length_penalty` alpha divides the final scores by
    length**alpha for ranking (0 ranks by raw log-prob).  `max_len`
    over-allocates the KV cache as in `generate`."""
    if int(num_beams) < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    n = int(max_new_tokens)
    if n <= 0:
        return (torch.zeros((b, 0), dtype=torch.long, device=dev),
                torch.zeros((b,), dtype=torch.float32, device=dev))
    if max_len is None:
        max_len = p + n
    elif max_len < p + n:
        raise ValueError(f"max_len={max_len} < prompt({p}) + "
                         f"max_new_tokens({n})")
    w = int(num_beams)
    cache = init_cache(net, b, int(max_len), params_dtype(params), dev)
    logits, cache = forward_cached(net, params, prompt, cache, 0)
    lp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
    vocab = lp0.shape[-1]
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id={eos_id} out of range for vocab size "
                         f"{vocab}")
    # only min(W, V) distinct beams exist after one token: the rest get
    # -1e30 scores (and the first token), so they never outrank a real
    # candidate
    k0 = min(w, vocab)
    scores, tok = top_k(lp0, k0)
    if k0 < w:
        scores = torch.cat([scores, scores.new_full((b, w - k0), -1e30)],
                           dim=1)
        tok = torch.cat([tok, tok[:, :1].expand(b, w - k0)], dim=1)
    cache = {name: {side: a.repeat_interleave(w, dim=0)
                    for side, a in entry.items()}
             for name, entry in cache.items()}
    seqs = torch.zeros((b, w, n), dtype=torch.long, device=dev)
    seqs[:, :, 0] = tok
    done = (tok == eos_id if eos_id is not None
            else torch.zeros((b, w), dtype=torch.bool, device=dev))
    lengths = torch.ones((b, w), dtype=torch.int32, device=dev)
    if eos_id is not None:
        # a finished beam only continues with eos at zero cost, so its
        # score freezes and it cannot spawn siblings
        frozen = torch.full((vocab,), -1e30, device=dev)
        frozen[eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * w
    last = tok
    for t in range(1, n):
        logits, cache = forward_cached(net, params, last.reshape(b * w, 1),
                                       cache, p + t - 1)
        lp = torch.log_softmax(logits[:, -1].float(),
                               dim=-1).reshape(b, w, vocab)
        if eos_id is not None:
            lp = torch.where(done[:, :, None], frozen, lp)
        cand = (scores[:, :, None] + lp).reshape(b, w * vocab)
        scores, idx = top_k(cand, w)
        beam = idx // vocab
        last = idx % vocab
        seqs = torch.take_along_dim(seqs, beam[:, :, None], dim=1)
        seqs[:, :, t] = last
        done = torch.gather(done, 1, beam)
        lengths = torch.where(done, torch.gather(lengths, 1, beam),
                              torch.full_like(lengths, t + 1))
        if eos_id is not None:
            done = done | (last == eos_id)
        flat = (rows + beam).reshape(-1)
        cache = {name: {side: a.index_select(0, flat)
                        for side, a in entry.items()}
                 for name, entry in cache.items()}
    ranked = (scores / lengths.float() ** length_penalty
              if length_penalty else scores)
    best = torch.argmax(ranked, dim=1)
    pick = torch.arange(b, device=dev)
    return seqs[pick, best], scores[pick, best]
