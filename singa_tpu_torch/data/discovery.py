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

The port's own copy of `singa_tpu/data/discovery.py`.
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


def _peek_shard(path: str) -> Optional[Tuple[int, ...]]:
    """Shape of the first usable image record in a shard folder."""
    from .records import Record, record_has_image
    from .shard import Shard

    shard = Shard(path, Shard.KREAD)
    try:
        for _, val in shard:
            if not record_has_image(val):
                continue
            rec = Record.decode(val)
            if rec.image and rec.image.shape:
                return tuple(rec.image.shape)
    finally:
        shard.close()
    return None


def _peek_lmdb(path: str) -> Optional[Tuple[int, ...]]:
    """Shape of the first usable Datum in an LMDB environment."""
    from .lmdb_reader import iter_lmdb
    from .records import Datum, record_from_datum

    for _, raw in iter_lmdb(path):
        rec = record_from_datum(Datum.decode(raw))
        if rec.image and rec.image.shape and (rec.image.pixel
                                              or rec.image.data):
            return tuple(rec.image.shape)
    return None


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
            pix = None
            path = layer.data_param.path if layer.data_param else None
            live = (not force_synthetic and
                    (shard_source_exists(path)
                     if layer.type == "kShardData"
                     else lmdb_source_exists(path)))
            if live:
                # a live source will be SERVED (resolve_data_source
                # uses the same predicates) — a peek failure must fail
                # loudly here, not guess a geometry the real records
                # won't match at an opaque jit shape error later.
                # Reader errors (LMDBFormatError, ShardError, corrupt
                # Record ValueError) propagate unchanged: they carry
                # the fail-loud contract's specific diagnosis.
                pix = (_peek_shard(path)
                       if layer.type == "kShardData"
                       else _peek_lmdb(path))
                if pix is None:
                    raise ValueError(
                        f"data layer {layer.name!r}: source {path!r} "
                        f"contains no usable image records")
            else:
                pix = _infer_from_parsers(layers, layer.name)
            shapes.setdefault(layer.name, {"pixel": tuple(pix),
                                           "label": ()})
        elif layer.type == "kSequenceData" and layer.seqdata_param:
            s = layer.seqdata_param.seq_len
            shapes.setdefault(layer.name, {"input": (s,),
                                           "target": (s,)})
    return shapes
