"""Synthetic data sources: the port's own copy of
`singa_tpu/data/synthetic.py`, so both packages draw the same batches
from one seed without any dataset on disk.

Provides deterministic, learnable synthetic classification batches shaped
like the reference's MNIST/CIFAR records so training loops and benchmarks
exercise the identical compute path.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def synthetic_image_batches(
        batchsize: int,
        image_shape: Tuple[int, ...] = (28, 28),
        nclass: int = 10,
        data_layer: str = "data",
        seed: int = 0,
        learnable: bool = True,
        dtype=np.uint8,
        stream_seed: Optional[int] = None,
        noise_std: float = 64.0) -> Iterator[Dict]:
    """Infinite iterator of {data_layer: {"pixel": u8, "label": i32}}.

    When `learnable`, each class k has a fixed random template and samples
    are noisy copies — so accuracy above chance proves learning end to end.

    `seed` fixes the class templates.  `stream_seed` fixes the
    label/noise stream independently; when omitted, the stream simply
    continues the template RNG (the original behavior — note this is
    NOT the same stream as an explicit stream_seed=seed, which
    re-seeds from scratch).  A held-out test split is the SAME
    templates with a different stream_seed (train/test
    generalization, not memorization of identical batches).
    `noise_std` sets the per-pixel gaussian corruption (higher =
    harder task).  Pick stream_seed != seed so the stream does not
    replay the bit sequence that generated the templates.
    """
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (nclass,) + tuple(image_shape))
    stream = (rng if stream_seed is None
              else np.random.default_rng(stream_seed))
    while True:
        labels = stream.integers(0, nclass, (batchsize,))
        if learnable:
            noise = stream.normal(0, noise_std,
                                  (batchsize,) + tuple(image_shape))
            pixel = np.clip(templates[labels] + noise, 0, 255)
        else:
            pixel = stream.integers(0, 256,
                                    (batchsize,) + tuple(image_shape))
        yield {data_layer: {
            "pixel": pixel.astype(dtype),
            "label": labels.astype(np.int32),
        }}
