"""Elastic distortion of MNIST-shaped images: kMnistImage's augmentation.

Port of `singa_tpu/ops/augment.py:23-90`.  MnistProto (model.proto:
211-225) declares kernel, sigma, alpha (an elastic displacement field),
beta (rotation, degrees), gamma (scaling, percent); the reference left
its implementation commented out (layer.cc:380-473) and the JAX package
runs it in the jitted step.  Per image: the displacement field is
uniform(-1, 1) noise blurred by a Gaussian kernel and scaled by `alpha`
pixels (when kernel > 0 and alpha > 0); the affine map rotates by
U(-beta, beta) degrees and scales each axis by U(1 - gamma/100,
1 + gamma/100) about the image centre; the result is sampled bilinearly
with edge clamping.

The draws and the warp are two functions: `elastic_draws` takes the four
fields from a `torch.Generator`, and `elastic_warp` is deterministic in
them, so a test can feed it the draws JAX takes from its key.  Every op
is a tensor op on the images' device with no host sync, so the warp runs
inside a captured train step.  It is plain torch: the JAX package runs
it in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gaussian_kernel(size: int, sigma: float,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Normalized (size, size) Gaussian filter, in f32."""
    r = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2.0 * max(sigma, 1e-6) ** 2))
    k = torch.outer(g, g)
    return k / torch.sum(k)


def _blur(field: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise SAME blur of a (B, H, W) field, padded as XLA pads SAME:
    k // 2 before and (k - 1) // 2 after, which differ for an even k."""
    k = kernel.shape[0]
    lo, hi = k // 2, (k - 1) // 2
    padded = F.pad(field[:, None], (lo, hi, lo, hi))
    return F.conv2d(padded, kernel[None, None])[:, 0]


def elastic_draws(b: int, h: int, w: int, generator: torch.Generator,
                  device: torch.device, *, kernel: int = 0,
                  alpha: float = 0.0, beta: float = 0.0, gamma: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(rotation degrees (B,), scale offsets in percent (B, 2), dx, dy):
    U(-beta, beta), U(-gamma, gamma), and the (B, H, W) U(-1, 1) fields,
    which are None when the elastic field is off (kernel or alpha 0)."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo
    rot = uniform((b,), -beta, beta)
    sc = uniform((b, 2), -gamma, gamma)
    if kernel > 0 and alpha > 0:
        return (rot, sc, uniform((b, h, w), -1.0, 1.0),
                uniform((b, h, w), -1.0, 1.0))
    return rot, sc, None, None


def elastic_warp(x: torch.Tensor, rot: torch.Tensor, sc: torch.Tensor,
                 dx: Optional[torch.Tensor], dy: Optional[torch.Tensor], *,
                 kernel: int = 0, sigma: float = 0.0, alpha: float = 0.0
                 ) -> torch.Tensor:
    """The deformation of a (B, H, W) f32 batch given its draws (see
    `elastic_draws`): the inverse affine about the centre, plus the
    blurred fields scaled by `alpha` when given, clipped to the image,
    then bilinear sampling as `map_coordinates(order=1, mode="nearest")`,
    with its products and sums in its order."""
    b, h, w = x.shape
    dev = x.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yc, xc = yy - cy, xx - cx
    theta = rot * math.pi / 180.0
    scale = 1.0 + sc / 100.0
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    gy = yc[None] / scale[:, 0, None, None]
    gx = xc[None] / scale[:, 1, None, None]
    src_y = cos * gy + sin * gx
    src_x = -sin * gy + cos * gx
    if dx is not None and kernel > 0 and alpha > 0:
        kern = gaussian_kernel(kernel, sigma, dev)
        src_y = src_y + _blur(dy, kern) * alpha
        src_x = src_x + _blur(dx, kern) * alpha
    coords_y = torch.clamp(src_y + cy, 0.0, h - 1)
    coords_x = torch.clamp(src_x + cx, 0.0, w - 1)
    return _bilinear(x, coords_y, coords_x)


def _bilinear(x: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor
              ) -> torch.Tensor:
    """x (B, H, W) sampled at (cy, cx) (B, H, W): floor, the two neighbours
    per axis with indices clamped to the image, and the four products
    (wy · wx) · value summed in the order JAX's map_coordinates sums
    them."""
    b, h, w = x.shape
    y0f, x0f = torch.floor(cy), torch.floor(cx)
    wy1, wx1 = cy - y0f, cx - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.long(), x0f.long()
    ys = (y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1))
    xs = (x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1))
    flat = x.reshape(b, h * w)
    out = None
    for yi, wy in zip(ys, (wy0, wy1)):
        for xi, wx in zip(xs, (wx0, wx1)):
            v = torch.gather(flat, 1, (yi * w + xi).reshape(b, -1))
            term = (wy * wx) * v.reshape(b, h, w)
            out = term if out is None else out + term
    return out


def elastic_deform(x: torch.Tensor, generator: torch.Generator, *,
                   kernel: int = 0, sigma: float = 0.0, alpha: float = 0.0,
                   beta: float = 0.0, gamma: float = 0.0,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Random elastic and affine deformation of a (B, H, W) f32 batch,
    drawn from `generator` (rotation, scales, then dx and dy).  All
    strengths zero gives the identity.  `rows` (global rows, first row)
    draws for a global batch and keeps x's rows (x is one slice under
    data parallelism)."""
    b, h, w = x.shape
    gb, lo = rows if rows is not None else (b, 0)
    draws = elastic_draws(gb, h, w, generator, x.device, kernel=kernel,
                          alpha=alpha, beta=beta, gamma=gamma)
    rot, sc, dx, dy = (None if d is None else d[lo:lo + b] for d in draws)
    return elastic_warp(x, rot, sc, dx, dy, kernel=kernel, sigma=sigma,
                        alpha=alpha)
