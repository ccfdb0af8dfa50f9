"""Softmax cross-entropy loss + top-k precision metric.

Port of `singa_tpu/ops/loss.py` (SINGA's SoftmaxLossLayer, layer.cc:
702-765): loss = scale * mean(lse - label logit), precision = scale *
mean(label in top-k).  Computed in f32 whatever the input dtype; a bf16
product is taken as an f32 product of the upcast operands, which is the
JAX package's bf16 x bf16 -> f32 `preferred_element_type` product.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .topk import top_k


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """logits: (B, D); labels: (B,) int. Returns scalar mean NLL*scale."""
    logits = logits.reshape(logits.shape[0], -1).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return scale * torch.mean(lse - ll)


def topk_precision(logits: torch.Tensor, labels: torch.Tensor,
                   topk: int = 1, scale: float = 1.0) -> torch.Tensor:
    """Fraction of rows whose true label is in the top-k logits."""
    logits = logits.reshape(logits.shape[0], -1)
    hit = _hits(logits, labels.long(), topk)
    return scale * torch.mean(hit.float())


def softmax_loss_metrics(logits: torch.Tensor, labels: torch.Tensor,
                         topk: int = 1, scale: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, precision) — SINGA's metric blob layout."""
    return (softmax_cross_entropy(logits, labels, scale),
            topk_precision(logits, labels, topk, scale))


def _hits(logits, labels, topk: int):
    if topk == 1:
        # argmax keeps top_k's tie-break: the lowest index wins
        return torch.argmax(logits, dim=-1) == labels
    idx = top_k(logits, topk)[1]
    return torch.any(idx == labels[:, None], dim=-1)


def _largest_divisor_leq(n: int, target: int) -> int:
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def _chunk_stats(hc, lc, wf, topk: int, w_is_vE: bool):
    """(Σ nll, Σ hits) of one token chunk; its (chunk, V) f32 logits."""
    logits = hc.float() @ (wf.T if w_is_vE else wf)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, lc[:, None])[:, 0]
    return torch.sum(lse - ll), torch.sum(_hits(logits, lc, topk).float())


def chunked_lm_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    chunk_size: int = 4096, topk: int = 1,
                    scale: float = 1.0, w_is_vE: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM-head projection + softmax-xent + top-k precision over token
    chunks.  h: (N, E); w: (E, V), or with `w_is_vE` the (V, E) tied
    embedding layout (contracted on E without a transposed copy).

    Each chunk runs under activation checkpointing, as the JAX package's
    `jax.checkpoint` per chunk (singa_tpu/ops/loss.py:83): its logits are
    dropped after the forward and recomputed in the backward, so at most
    one chunk's (chunk, V) f32 logits live at a time."""
    n = h.shape[0]
    c = _largest_divisor_leq(n, chunk_size)
    wf = w.float()
    labels = labels.long()
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    hits = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n, c):
        d_nll, d_hits = checkpoint(_chunk_stats, h[i:i + c],
                                   labels[i:i + c], wf, topk, w_is_vE,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        nll = nll + d_nll
        hits = hits + d_hits
    return scale * nll / n, scale * hits / n
