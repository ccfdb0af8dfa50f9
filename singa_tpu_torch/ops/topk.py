"""Top-k with the JAX package's tie order.

`jax.lax.top_k` keeps the lowest index first among equal values
(`singa_tpu/ops/loss.py:35,101`, `ops/moe.py:44`, `models/generate.py:
376,407`); `torch.topk` does not promise any order for ties (on the CPU
it returns `[3, 5]` for the top 2 of six zeros, where JAX gives
`[0, 1]`).  A stable descending sort keeps equal values in index order,
so its first k entries are `lax.top_k`'s.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim,
    largest first and, among equal values, lowest index first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
