"""The port's data pipeline (`singa_tpu_torch/data/`) on the CPU, against
the JAX package's: records encode to the same bytes, a shard either
package writes reads in the other, `shard_batches` and `lmdb_batches`
give equal batches, the hardened `Prefetcher` (the cases of
`tests/test_faults.py`), `resolve_data_source` draws the same
synthetic streams for lm.conf and the mnist and cifar configs, shape
discovery peeks the same record geometry, the chunk stager keeps the
JAX dtypes, and `--feeder on` trains bit-equal to `--feeder off`."""

import os
import threading

import numpy as np
import pytest

from singa_tpu.config import load_model_config as jload
from singa_tpu.data import discover_input_shapes as jdiscover
from singa_tpu.data import pipeline as jpipeline
from singa_tpu.data import records as jrecords
from singa_tpu.data import resolve_data_source as jresolve
from singa_tpu.data.feed import ChunkStager as JChunkStager
from singa_tpu.data.shard import Shard as JShard

from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.data import discover_input_shapes, resolve_data_source
from singa_tpu_torch.data.feed import ChunkStager, DeviceFeeder
from singa_tpu_torch.data.pipeline import (PipelineStats, PrefetchError,
                                           Prefetcher, lmdb_batches,
                                           shard_batches)
from singa_tpu_torch.data.records import (Datum, Record,
                                          SingleLabelImageRecord)
from singa_tpu_torch.data.shard import Shard
from singa_tpu_torch.utils.faults import FaultSchedule, FaultSpec, inject

from lmdb_fixture import write_lmdb
from test_torch_supervisor import assert_equal, data, mlp, port_trainer

pytestmark = pytest.mark.port
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _records(n, shape=(3, 8, 8), seed=0):
    """(key, Record) pairs of random uint8 images with labels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        out.append((f"r{i:05d}", Record(image=SingleLabelImageRecord(
            shape=list(shape), label=int(rng.integers(0, 10)),
            pixel=img.tobytes()))))
    return out


def _jrecord(rec):
    im = rec.image
    return jrecords.Record(image=jrecords.SingleLabelImageRecord(
        shape=list(im.shape), label=im.label, pixel=im.pixel,
        data=list(im.data)))


def test_records_encode_to_the_jax_bytes():
    rng = np.random.default_rng(1)
    for _, rec in _records(5, shape=(2, 3, 3)):
        assert rec.encode() == _jrecord(rec).encode()
        assert Record.decode(rec.encode()) == rec
    floaty = Record(image=SingleLabelImageRecord(
        shape=[4], label=3, data=[float(x) for x in
                                  rng.standard_normal(4).astype(np.float32)]))
    assert floaty.encode() == _jrecord(floaty).encode()
    d = Datum(channels=3, height=2, width=2, data=bytes(range(12)), label=7)
    jd = jrecords.Datum(channels=3, height=2, width=2,
                        data=bytes(range(12)), label=7)
    assert d.encode() == jd.encode()
    assert Datum.decode(jd.encode()) == d


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_shard_either_package_writes_reads_in_the_other(writer, tmp_path):
    items = _records(7)
    W, R = (Shard, JShard) if writer == "port" else (JShard, Shard)
    with W(str(tmp_path), W.KCREATE) as sh:
        for k, rec in items:
            assert sh.insert(k, rec.encode())
    with R(str(tmp_path), R.KREAD) as sh:
        got = list(sh)
    assert [k for k, _ in got] == [k.encode() for k, _ in items]
    assert [v for _, v in got] == [rec.encode() for _, rec in items]


def _equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            for f in w[name]:
                assert g[name][f].dtype == w[name][f].dtype, f
                np.testing.assert_array_equal(g[name][f], w[name][f])


def test_shard_batches_equal_the_jax_batches(tmp_path):
    with Shard(str(tmp_path), Shard.KCREATE) as sh:
        for k, rec in _records(21):
            sh.insert(k, rec.encode())
    for kw in ({"loop": False}, {"loop": True, "random_skip": 5,
                                 "seed": 3}):
        got = shard_batches(str(tmp_path), 4, "d", **kw)
        want = jpipeline.shard_batches(str(tmp_path), 4, "d", **kw)
        n = 5 if kw["loop"] else 99
        _equal_batches([b for b, _ in zip(got, range(n))],
                       [b for b, _ in zip(want, range(n))])


def test_lmdb_batches_equal_the_jax_batches(tmp_path):
    rng = np.random.default_rng(2)
    items = [(b"%08d" % i, Datum(channels=3, height=4, width=4,
                                 data=rng.bytes(48), label=i % 5).encode())
             for i in range(11)]
    write_lmdb(str(tmp_path), items)
    got = list(lmdb_batches(str(tmp_path), 3, loop=False))
    want = list(jpipeline.lmdb_batches(str(tmp_path), 3, loop=False))
    _equal_batches(got, want)
    assert sum(b["data"]["pixel"].shape[0] for b in got) == 11


# -- Prefetcher hardening (tests/test_faults.py:209-283) ---------------------
def test_prefetcher_dead_producer_raises_not_hangs():
    class DeadProducer(Prefetcher):
        def _run(self):   # dies without sentinel or error
            return

    it = DeadProducer(iter([1, 2]), poll_timeout=0.05)
    it._thread.join(timeout=2.0)
    with pytest.raises(PrefetchError, match="died"):
        next(it)


def test_prefetcher_stall_timeout_bounds_the_wait():
    release = threading.Event()

    def slow():
        yield 1
        release.wait(10.0)
        yield 2

    it = Prefetcher(slow(), poll_timeout=0.05, stall_timeout=0.3)
    assert next(it) == 1
    with pytest.raises(PrefetchError, match="stalled"):
        next(it)
    release.set()
    it.close()


def test_prefetcher_quarantines_injected_corrupt_records():
    with inject(FaultSchedule([FaultSpec("data.decode", 1, "corrupt")])):
        it = Prefetcher(iter(range(5)), poll_timeout=0.05)
        got = list(it)
    assert got == [0, 1, 2, 3, 4]
    assert it.stats.quarantined == 1


def test_prefetcher_reraises_an_injected_prefetch_error():
    with inject(FaultSchedule([FaultSpec("data.prefetch", 2, "error")])):
        it = Prefetcher(iter(range(5)), poll_timeout=0.05)
        assert [next(it), next(it)] == [0, 1]
        with pytest.raises(Exception, match="data.prefetch"):
            next(it)
    it.close()


def test_prefetcher_close_unblocks_a_full_queue():
    it = Prefetcher(iter(range(1000)), depth=1, poll_timeout=0.05)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()


def test_shard_batches_quarantine_a_corrupt_record(tmp_path):
    with Shard(str(tmp_path), Shard.KCREATE) as sh:
        for k, rec in _records(8, shape=(4, 4)):
            sh.insert(k, rec.encode())
        sh.insert("rbad", b"\x12\xff")
    stats = PipelineStats()
    batches = list(shard_batches(str(tmp_path), batchsize=4, loop=False,
                                 stats=stats))
    assert sum(b["data"]["pixel"].shape[0] for b in batches) == 8
    assert stats.quarantined == 1 and stats.passes == 1


# -- resolve_data_source, discovery ------------------------------------------
@pytest.mark.parametrize("conf,bs", [
    ("transformer/lm.conf", 2), ("mnist/mlp.conf", 16),
    ("mnist/conv.conf", 16), ("cifar10/alexnet.conf", 8)])
def test_resolve_data_source_draws_the_jax_synthetic_streams(conf, bs):
    path = os.path.join(EXAMPLES, conf)
    it, test_factory = resolve_data_source(load_model_config(path), bs,
                                           seed=5, force_synthetic=True)
    jit, jtest_factory = jresolve(jload(path), bs, seed=5,
                                  force_synthetic=True)
    try:
        _equal_batches([next(it) for _ in range(2)],
                       [next(jit) for _ in range(2)])
    finally:
        it.close()
        jit.close()
    t, jt = test_factory(), jtest_factory()
    _equal_batches([next(t) for _ in range(2)], [next(jt) for _ in range(2)])


def _cifar_conf(tmp_path, folder):
    """examples/cifar10/alexnet.conf with data_param.path set."""
    with open(os.path.join(EXAMPLES, "cifar10", "alexnet.conf")) as f:
        text = f.read()
    text = text.replace("batchsize: 1024",
                        f'batchsize: 4\n      path: "{folder}"', 1)
    out = os.path.join(str(tmp_path), "alexnet.conf")
    with open(out, "w") as f:
        f.write(text)
    return out


@pytest.mark.parametrize("kind", ["shard", "lmdb"])
def test_discovery_peeks_the_record_geometry_as_jax_does(kind, tmp_path):
    folder = os.path.join(str(tmp_path), "src")
    shape = (3, 36, 36)             # not the geometry the parsers imply
    if kind == "shard":
        os.makedirs(folder)
        with Shard(folder, Shard.KCREATE) as sh:
            for k, rec in _records(3, shape=shape):
                sh.insert(k, rec.encode())
    else:
        write_lmdb(folder, [(b"%08d" % i, Datum(
            channels=3, height=36, width=36, data=bytes(3 * 36 * 36),
            label=1).encode()) for i in range(2)])
    conf = _cifar_conf(tmp_path, folder)
    if kind == "lmdb":
        with open(conf) as f:
            text = f.read().replace("kShardData", "kLMDBData")
        with open(conf, "w") as f:
            f.write(text)
    got = discover_input_shapes(load_model_config(conf))
    want = jdiscover(jload(conf))
    assert got == want
    assert got["data"]["pixel"] == shape
    assert discover_input_shapes(load_model_config(conf),
                                 force_synthetic=True)["data"]["pixel"] \
        == (3, 32, 32)


# -- the feed ------------------------------------------------------------------
def test_the_stager_keeps_the_jax_dtypes_and_values():
    rng = np.random.default_rng(4)
    batches = [{"d": {"x": rng.standard_normal((2, 3)),          # f64
                      "i": rng.integers(0, 9, (2,)),            # i64
                      "u": rng.integers(0, 9, (2, 2)).astype(np.uint8)}}
               for _ in range(3)]
    got = ChunkStager("cpu", capacity=4).stage(batches).take()
    want = JChunkStager(capacity=4).stage(batches)
    for f in ("x", "i", "u"):
        w = np.asarray(want["d"][f])
        assert got["d"][f].numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(got["d"][f].numpy(), w)


def test_the_feeder_stages_the_plan_and_reraises_a_stage_fault():
    plan = [(0, 2), (2, 3), (5, 1)]
    fd = DeviceFeeder(iter(range(6)), plan, "cpu", depth=1)
    got = [fd.get() for _ in plan]
    assert [(c.start, c.length) for c in got] == plan
    with pytest.raises(StopIteration):
        fd.get()
    fd.close()
    with inject(FaultSchedule([FaultSpec("feed.stage", 1, "error")])):
        fd = DeviceFeeder(iter(range(6)), plan, "cpu", depth=1)
        assert fd.get().start == 0
        with pytest.raises(Exception, match="feed.stage"):
            fd.get()
        fd.close()


@pytest.mark.parametrize("depth", [1, 3])
def test_feeder_on_trains_bit_equal_to_feeder_off(depth):
    """Chunks of 5 cut at the saves (every 4 steps, with no workspace:
    the cuts alone) and a display every 3 steps."""
    cfg = dict(mlp(train_steps=14, ckpt_freq=4), display_frequency=3)
    runs = {}
    for feeder in (False, True):
        tr = port_trainer(cfg)
        p, o = tr.init()
        seen = []
        runs[feeder] = tr.run(p, o, data(), seed=0, scan_chunk=5,
                              feeder=feeder, feeder_depth=depth,
                              hooks=[lambda s, m: seen.append(s)])[0], seen
    assert_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1] == list(range(14))
    tr = port_trainer(mlp(train_steps=14, ckpt_freq=0))
    p, o = tr.init()
    assert_equal(runs[True][0], tr.run(p, o, data(), seed=0)[0])
