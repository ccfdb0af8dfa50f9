"""Input-shape discovery for data layers.

The reference learns record geometry from the data itself: the data/parser
layers read the first record during Setup and size their blobs from its
shape (layer.cc:388-392 MnistImageLayer reads a sample record;
layer.cc:576-585 RGBImageLayer sizes from `sample.shape()` or the mean
record).  Same contract here: when the configured source exists locally,
peek its first usable record; when it does not (the zero-egress synthetic
path), infer the geometry the parser expects from the net itself —
kMnistImage parses 28x28 grayscale records, kRGBImage parses (3, S, S)
records whose S the crop geometry implies.

The port's own copy of `singa_tpu/data/discovery.py`.  Without record
readers (ROADMAP.md A7) it infers every geometry from the net; a live
local source raises (`serve` calls it with `force_synthetic=True`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple


def shard_source_exists(path: Optional[str]) -> bool:
    """Whether a shard folder is a live local source — the single
    predicate both shape discovery and data serving use, so the net is
    always built for the geometry that will actually be served."""
    return bool(path) and os.path.isfile(os.path.join(path, "shard.dat"))


def lmdb_source_exists(path: Optional[str]) -> bool:
    return bool(path) and (os.path.isfile(path) or os.path.isfile(
        os.path.join(path, "data.mdb")))


def _peek_record_shape(path: str) -> Tuple[int, ...]:
    """The JAX package peeks the first usable image record of a live
    shard folder or LMDB environment here; the port has no record
    readers yet (`data/records.py`, `shard.py`, `lmdb_reader.py`:
    ROADMAP.md A7), so a live source raises rather than guessing."""
    raise NotImplementedError(
        f"reading the record geometry of {path!r} needs the port's "
        f"record readers (ROADMAP.md A7); pass force_synthetic=True")


def _infer_from_parsers(layers, data_name: str) -> Tuple[int, ...]:
    """Record geometry implied by the parsers consuming a data layer.

    kMnistImage → (28, 28): the MNIST record layout the parser's
    normalization contract assumes (layer.cc:380-473).  kRGBImage →
    (3, S, S): when the parser crops, the record must be at least
    cropsize — use the classic dataset margins (CIFAR crops 28 from
    32-pixel records, ILSVRC crops 227 from 256), giving the random-crop
    path real freedom; uncropped RGB defaults to CIFAR's 32.  A data
    layer with no image parser (e.g. feeding kRBM via kMnistImage
    upstream or raw) falls back to MNIST geometry.
    """
    for layer in layers:
        if data_name not in (layer.srclayers or []):
            continue
        if layer.type == "kMnistImage":
            return (28, 28)
        if layer.type == "kRGBImage":
            p = layer.rgbimage_param
            cs = p.cropsize if p else 0
            if not cs:
                return (3, 32, 32)
            margin = 29 if cs >= 100 else 4
            return (3, cs + margin, cs + margin)
    return (28, 28)


def discover_input_shapes(model_cfg, force_synthetic: bool = False
                          ) -> Dict[str, Dict[str, tuple]]:
    """Per-data-layer sample shapes for NeuralNet construction.

    Returns {data_layer_name: {"pixel": shape, "label": ()}} for every
    kShardData/kLMDBData layer and {"input"/"target"} for kSequenceData.
    Real sources win (the record IS the schema); synthetic inference is
    the fallback, so a conf pointing at a live shard trains at the
    shard's true geometry even if it differs from the dataset's classic
    one.
    """
    shapes: Dict[str, Dict[str, tuple]] = {}
    layers = model_cfg.neuralnet.layer if model_cfg.neuralnet else []
    for layer in layers:
        if layer.type in ("kShardData", "kLMDBData"):
            path = layer.data_param.path if layer.data_param else None
            live = (not force_synthetic and
                    (shard_source_exists(path)
                     if layer.type == "kShardData"
                     else lmdb_source_exists(path)))
            if live:
                # a live source would be SERVED: fail loudly rather
                # than guess a geometry its records may not match
                pix = _peek_record_shape(path)
            else:
                pix = _infer_from_parsers(layers, layer.name)
            shapes.setdefault(layer.name, {"pixel": tuple(pix),
                                           "label": ()})
        elif layer.type == "kSequenceData" and layer.seqdata_param:
            s = layer.seqdata_param.seq_len
            shapes.setdefault(layer.name, {"input": (s,),
                                           "target": (s,)})
    return shapes
