"""Data subsystem: Shard store, record codecs, loaders, prefetch, and the
overlapped device feed.  The port's own copy of `singa_tpu/data/__init__.py`
(its `resolve_data_source`), over the port's modules."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

from .discovery import discover_input_shapes
from .records import Datum, Record, SingleLabelImageRecord
from .shard import Shard, ShardError
from .feed import ChunkStager, DeviceFeeder, FeedChunk, FeedError
from .pipeline import (PipelineStats, PrefetchError, Prefetcher, prefetch,
                       shard_batches)
from .synthetic import synthetic_image_batches


def resolve_data_source(model_cfg, batchsize: int, seed: int = 0,
                        force_synthetic: bool = False,
                        stream_seed: int | None = None,
                        sample_shapes: dict | None = None
                        ) -> Tuple[Iterator, Callable[[], Iterator]]:
    """Pick (train_iter, test_iter_factory) for a model config: shard
    folders from DataProto.path when they exist locally, else synthetic.

    `seed` fixes the synthetic task (class templates / LM transition
    table); `stream_seed` varies only the sample stream — async replica
    groups pass a different stream_seed per replica so they train
    different data of the SAME task (a different `seed` would hand each
    replica an unrelated task and make their center average garbage).

    `sample_shapes` (data-layer name → field → per-sample shape, as
    discovery.discover_input_shapes returns) sizes the synthetic source
    so it matches the geometry the net was built for — RGB nets get
    (3, S, S) records, not MNIST's (28, 28).  Omitted, it is derived by
    the same discovery the Trainer path uses, so a caller can never get
    batches shaped differently from the net it built."""
    if sample_shapes is None:
        from .discovery import discover_input_shapes as _discover
        sample_shapes = _discover(model_cfg,
                                  force_synthetic=force_synthetic)
    # one stats object per resolved source: train iterator and every
    # test-factory iterator share the quarantine tally, and the
    # returned Prefetcher exposes it as `.stats`
    stats = PipelineStats()
    train_path = test_path = None
    train_name = test_name = "data"
    layers = model_cfg.neuralnet.layer if model_cfg.neuralnet else []

    # token-sequence models (kSequenceData): synthetic Markov LM data
    for layer in layers:
        if layer.type == "kSequenceData" and layer.seqdata_param:
            from ..models.transformer import synthetic_token_batches
            p = layer.seqdata_param
            # the transition table is keyed by table_seed (fixed), so
            # different seeds here already share one "language"
            mk = lambda s: synthetic_token_batches(  # noqa: E731
                batchsize, p.seq_len, p.vocab_size, seed=s,
                data_layer=layer.name, table_seed=1234 + seed)
            return (prefetch(mk(stream_seed if stream_seed is not None
                                else seed), stats=stats),
                    (lambda: mk(seed + 7919)))

    # the SAME existence predicates discovery uses to size the net —
    # the two must never diverge or served batches mismatch the net
    from .discovery import lmdb_source_exists, shard_source_exists

    def shard_ok(p):
        return not force_synthetic and shard_source_exists(p)

    def lmdb_ok(p):
        return not force_synthetic and lmdb_source_exists(p)

    train_skip = 0
    train_lmdb = test_lmdb = False
    for layer in layers:
        if layer.type in ("kShardData", "kLMDBData") and layer.data_param:
            is_lmdb = layer.type == "kLMDBData"
            if is_lmdb and not force_synthetic \
                    and not lmdb_ok(layer.data_param.path):
                import sys as _sys
                print(f"warning: kLMDBData layer {layer.name!r} "
                      f"path {layer.data_param.path!r} not found; "
                      f"using the synthetic source", file=_sys.stderr)
            if "kTrain" not in layer.exclude:
                train_path, train_name = layer.data_param.path, layer.name
                train_skip = layer.data_param.random_skip
                train_lmdb = is_lmdb
            else:
                test_path, test_name = layer.data_param.path, layer.name
                test_lmdb = is_lmdb

    def _warn_identical_streams(kind: str) -> None:
        # stream decorrelation on real sources rides
        # DataProto.random_skip (layer.cc:646-673): each stream_seed
        # draws a different initial skip; record order is otherwise
        # fixed.  Warn when a caller asks for distinct streams but the
        # config gives no skip budget.
        if stream_seed is not None and not train_skip:
            import sys as _sys
            print(f"warning: distinct data streams requested "
                  f"(stream_seed) but DataProto.random_skip is 0 — "
                  f"{kind} replicas will read identical record order",
                  file=_sys.stderr)

    from .pipeline import lmdb_batches
    if train_lmdb and lmdb_ok(train_path):
        _warn_identical_streams("LMDB")
        train_iter = prefetch(lmdb_batches(
            train_path, batchsize, train_name,
            seed=(stream_seed if stream_seed is not None else seed),
            random_skip=train_skip, stats=stats), stats=stats)
    elif shard_ok(train_path):
        _warn_identical_streams("shard")
        train_iter = prefetch(
            shard_batches(train_path, batchsize, train_name,
                          seed=(stream_seed if stream_seed is not None
                                else seed),
                          random_skip=train_skip, stats=stats),
            stats=stats)
    else:
        # train/test must share the class templates (`seed`) and differ
        # only in the sample stream — templates keyed by different
        # seeds are unrelated tasks and make test accuracy pure noise
        train_iter = prefetch(synthetic_image_batches(
            batchsize, data_layer=train_name, seed=seed,
            image_shape=_pixel_shape(sample_shapes, train_name),
            stream_seed=(stream_seed if stream_seed is not None
                         else seed + 101)), stats=stats)
    if test_lmdb and lmdb_ok(test_path):
        test_factory = lambda: lmdb_batches(
            test_path, batchsize, test_name, loop=False, stats=stats)
    elif shard_ok(test_path):
        test_factory = lambda: shard_batches(
            test_path, batchsize, test_name, loop=False, stats=stats)
    else:
        test_factory = lambda: synthetic_image_batches(
            batchsize, data_layer=test_name, seed=seed,
            image_shape=_pixel_shape(sample_shapes, test_name),
            stream_seed=seed + 202)
    return train_iter, test_factory


def _pixel_shape(sample_shapes: dict | None, layer_name: str):
    if sample_shapes and layer_name in sample_shapes:
        return tuple(sample_shapes[layer_name].get("pixel", (28, 28)))
    return (28, 28)
