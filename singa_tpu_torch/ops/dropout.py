"""Dropout, reference numerics (layer.cc:126-160).

Port of `singa_tpu/ops/dropout.py:22-30`: mask = 1[u < pkeep] / pkeep in
x's dtype, y = x * mask; autograd through the masked product reuses the
mask in the backward, as the reference does.  The uniform draws come
from an explicit `torch.Generator` (the layer's, see
`core.layers.Context.layer_rng`); its bits are not JAX's threefry bits,
so the two packages agree in distribution, not mask for mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            train: bool = True,
            rows: Optional[Tuple[int, int]] = None,
            cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """`rows` (global rows, first row) draws the mask of a global batch
    and keeps x's rows of it (x is one slice under data parallelism);
    `cols` does the same for dim 1 (x is one chunk of the sequence under
    sequence parallelism)."""
    if not train or rate <= 0.0:
        return x
    pkeep = 1.0 - rate
    # 1 / pkeep as x's dtype computes it (pkeep rounded first), taken on
    # the host: no copy to the device per call
    inv = float(torch.tensor(1.0, dtype=x.dtype)
                / torch.tensor(pkeep, dtype=x.dtype))
    b = x.shape[0]
    gb, lo = rows if rows is not None else (b, 0)
    if x.dim() > 1:
        s = x.shape[1]
        gs, c0 = cols if cols is not None else (s, 0)
        u = torch.rand((gb, gs) + tuple(x.shape[2:]), generator=generator,
                       device=x.device)[lo:lo + b, c0:c0 + s]
    else:
        u = torch.rand((gb,), generator=generator,
                       device=x.device)[lo:lo + b]
    return x * ((u < pkeep).to(x.dtype) * inv)
