"""Weights and batches made on the device from the run's seed.

One generator on the device and one large draw: every "normal" param is
a view of one flat standard-normal tensor, scaled in place; a
"constant" param is filled.  The same seed gives the same weights, so
the reference draws them again after the program's state is freed
instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# distinct streams of one seed: weights, batches, traffic
WEIGHTS, BATCHES = 0x5EED0001, 0x5EED0002


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))
    return g


def make(shapes: Iterable[Tuple[str, tuple, str, float]], seed: int,
         device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """name -> tensor of `dtype` on `device`, from `param_shapes`-style
    (name, shape, init, value) rows."""
    shapes = list(shapes)
    n = sum(int(torch.Size(s).numel()) for _, s, init, _ in shapes
            if init == "normal")
    flat = torch.randn(n, generator=generator(seed, WEIGHTS, device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init, value in shapes:
        size = int(torch.Size(shape).numel())
        if init == "normal":
            t = flat[at:at + size].view(shape).mul_(value)
            at += size
        elif init == "constant":
            t = torch.full(shape, float(value), device=device,
                           dtype=torch.float32)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t if dtype == torch.float32 else t.to(dtype)
    return out


def token_batches(seed: int, n: int, b: int, s: int, vocab: int,
                  device) -> Dict[str, torch.Tensor]:
    """n batches of (b, s) next-token pairs of uniform random ids, as
    (n, b, s) int32 "input" and "target"."""
    toks = torch.randint(0, vocab, (n, b, s + 1),
                         generator=generator(seed, BATCHES, device),
                         device=device, dtype=torch.int64).to(torch.int32)
    return {"input": toks[:, :, :-1].contiguous(),
            "target": toks[:, :, 1:].contiguous()}


def image_batches(seed: int, n: int, b: int, pixel: tuple, classes: int,
                  device) -> Dict[str, torch.Tensor]:
    """n batches of b images of byte values (as float32) and labels."""
    g = generator(seed, BATCHES, device)
    px = torch.randint(0, 256, (n, b) + tuple(pixel), generator=g,
                       device=device, dtype=torch.int32).float()
    lab = torch.randint(0, classes, (n, b), generator=g, device=device,
                        dtype=torch.int32)
    return {"pixel": px, "label": lab}
