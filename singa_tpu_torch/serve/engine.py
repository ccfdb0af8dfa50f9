"""Inference engine of the port: bucketed generate/predict over left-padded
micro-batches.

Port of the serving core of `singa_tpu/serve/engine.py` (`ServeSpec`
`:59-260`, `_left_pad_mask` `:261-270`, the generate/predict programs
`:602-654` and `run_batch` `:903-931`).  Variable-length prompts are
LEFT-padded to the bucket length with a per-key validity mask: RoPE
rotations are relative, so left-padding keeps every attended (query,
key) distance, the last real prompt token sits at P-1 in every row, and
masked pad keys weigh exactly zero after softmax.

The JAX engine compiles one program per bucket; the port runs eagerly,
so a bucket here is only the padded shape.  Checkpoint reload,
continuous batching, stats, tracing and the HTTP/wire front ends come
with later slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, params_dtype, resolve_device
from ..models.generate import decode, forward_cached, init_cache

MODES = ("generate", "predict")


@dataclass(frozen=True)
class ServeSpec:
    """Serving configuration.  `buckets` is the closed set of
    (batch, prompt_len) shapes every request is padded into;
    `bucket_for` picks the smallest admissible one."""
    buckets: Tuple[Tuple[int, int], ...] = ((1, 16), (4, 16), (8, 32))
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    pad_id: int = 0
    seed: int = 0

    def __post_init__(self):
        norm = []
        for b in self.buckets:
            bb, pp = int(b[0]), int(b[1])
            if bb < 1 or pp < 1:
                raise ValueError(f"bad bucket {b!r}: batch and "
                                 f"prompt_len must be >= 1")
            norm.append((bb, pp))
        if not norm:
            raise ValueError("ServeSpec needs at least one bucket")
        object.__setattr__(self, "buckets",
                           tuple(sorted(set(norm),
                                        key=lambda c: (c[1], c[0]))))
        if int(self.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")

    def bucket_for(self, n: int, prompt_len: int) -> Tuple[int, int]:
        """Smallest admissible bucket for `n` requests whose longest
        prompt is `prompt_len` (fewest padded slots first, then shortest
        prompt padding); the widest admissible one when none holds all
        `n`."""
        cands = [c for c in self.buckets if c[1] >= prompt_len]
        if not cands:
            raise ValueError(
                f"prompt_len={prompt_len} exceeds every bucket "
                f"{self.buckets}; admission should have rejected it")
        fit = [c for c in cands if c[0] >= n]
        if fit:
            return min(fit, key=lambda c: (c[0], c[1]))
        return min(cands, key=lambda c: (-c[0], c[1]))

    @classmethod
    def parse(cls, spec: str) -> "ServeSpec":
        """Comma/semicolon-separated `key=value`; buckets are
        `/`-separated BxP entries, e.g.
        `"buckets=1x8/4x16,max_new_tokens=8,eos_id=2"`.  `eos_id=none`
        clears the eos."""
        kw: Dict[str, Any] = {}
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                key, _, val = part.partition("=")
                key, val = key.strip(), val.strip()
                if key not in types:
                    raise ValueError(f"unknown key {key!r}")
                if key == "buckets":
                    kw[key] = tuple(
                        tuple(int(x) for x in item.lower().split("x"))
                        for item in val.split("/") if item)
                elif key == "eos_id":
                    kw[key] = None if val.lower() in ("none", "") \
                        else int(val)
                elif "float" in str(types[key]):
                    kw[key] = float(val)
                else:
                    kw[key] = int(val)
            except ValueError as e:
                raise ValueError(f"bad serve spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


def _left_pad_mask(prompt_len: int, max_len: int,
                   plens: torch.Tensor) -> torch.Tensor:
    """(B, max_len) bool: key position j of row i is attendable iff
    j >= prompt_len - plens[i].  Every generated position is attendable
    for all rows."""
    kpos = torch.arange(max_len, device=plens.device)[None, :]
    return kpos >= (prompt_len - plens)[:, None]


def left_pad(prompts: Sequence[Sequence[int]], bucket: Tuple[int, int],
             pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (B, P) int32, plens (B,) int32) for up to B prompts in a
    (B, P) bucket, as the JAX batcher packs them: each prompt at the
    right end of its row, unused rows a 1-token dummy."""
    b, p = bucket
    if len(prompts) > b or any(len(r) > p for r in prompts):
        raise ValueError(f"{len(prompts)} prompts do not fit bucket {bucket}")
    tokens = np.full((b, p), pad_id, np.int32)
    plens = np.ones((b,), np.int32)
    for i, r in enumerate(prompts):
        tokens[i, p - len(r):] = r
        plens[i] = len(r)
    return tokens, plens


class InferenceEngine:
    """Serves `params` on `device` (CUDA unless the caller passes
    device='cpu'): `run_batch` runs one left-padded micro-batch in
    generate or predict mode."""

    def __init__(self, net, spec: ServeSpec, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None):
        self.net = net
        self.spec = spec
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._gen = torch.Generator(device=self.device)
        self._key_counter = 0

    def _next_generator(self) -> torch.Generator:
        # one stream per batch, from (seed, batch count) as the JAX
        # engine derives its per-batch key
        n = self.spec.seed * 1000003 + self._key_counter
        self._key_counter += 1
        self._gen.manual_seed(n)
        return self._gen

    def run_batch(self, mode: str, tokens: np.ndarray,
                  plens: np.ndarray) -> np.ndarray:
        """Run one padded micro-batch.  `tokens` (B, P) LEFT-padded with
        spec.pad_id, `plens` (B,) real prompt lengths.  Returns (B,
        max_new_tokens) int32 for generate, (B, V) float32 next-token
        log-probs for predict."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
        params, spec = self.params, self.spec
        b, p = tokens.shape
        tok = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        pl = torch.as_tensor(np.asarray(plens), device=self.device).long()
        with torch.no_grad():
            if mode == "generate":
                max_new = int(spec.max_new_tokens)
                kmask = _left_pad_mask(p, p + max_new, pl)
                out = decode(self.net, params, tok, max_new,
                             self._next_generator(), float(spec.temperature),
                             int(spec.top_k), float(spec.top_p),
                             spec.eos_id, p + max_new, kmask)
                return out.to(torch.int32).cpu().numpy()
            cache = init_cache(self.net, b, p + 1, params_dtype(params),
                               self.device)
            logits, _ = forward_cached(self.net, params, tok, cache, 0,
                                       kmask=_left_pad_mask(p, p + 1, pl))
            # left-padding puts every row's last real token at P-1
            return torch.log_softmax(logits[:, -1].float(),
                                     dim=-1).cpu().numpy()

    def answer(self, mode: str, prompts: List[Sequence[int]]
               ) -> List[np.ndarray]:
        """Pad `prompts` into their bucket, run them, and return each
        request's own row."""
        bucket = self.spec.bucket_for(len(prompts),
                                      max(len(r) for r in prompts))
        tokens, plens = left_pad(prompts, bucket, self.spec.pad_id)
        out = self.run_batch(mode, tokens, plens)
        return [out[i] for i in range(len(prompts))]
