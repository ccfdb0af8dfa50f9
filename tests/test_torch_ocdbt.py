"""The port's own reader of the JAX package's orbax checkpoints, held
against tensorstore and the JAX package on the CPU.

- zstd (`singa_tpu_torch/utils/zstd.py`, the plain decoder): the zarr
  chunks tensorstore writes at zstd levels -5, 1, 3, 9 and 19 (zeros,
  ramps, repeated rows, random f32, bf16 and u32, arrays that span
  several 128 KiB blocks) decode to the bytes tensorstore reads back,
  and the decoder's counters show every block, literals and table mode
  taken; frames libzstd writes with a content checksum (through the
  `zstandard` package), skippable frames, a dictionary id, and corrupt
  and truncated frames.
- OCDBT (`utils/ocdbt.py`): `list`/`read` equal tensorstore's `KvStore`
  over a step the JAX package wrote (inline and indirect values, the
  per-process data files) and over databases with interior B+tree nodes
  and version tree nodes; a flipped byte is a torn step, an unknown
  version or compression is refused by name.
- zarr (`utils/zarr.py`): v2 and v3 (sharded, as orbax writes it) reads
  equal tensorstore's for every dtype the reader takes, over OCDBT and
  plain files, with F order, `/` separators, zlib and gzip, transposes,
  CRC32C, a shard index at the start, missing chunks and inner chunks.
- The whole restore (`CheckpointManager(device="cpu")`), with
  `tensorstore` hidden from `sys.modules`: steps orbax writes with zarr
  v2 and sharded zarr3, over OCDBT and plain files, equal to the bit to
  the JAX package's own restore; torn steps walked past; the committed
  fixtures (`tests/torch_fixtures/orbax/`) equal to the JAX restore and
  to their recorded sha256.
- The native decoder (`singa_tpu_torch/csrc/zstd_dec.cu`, host code that
  g++ builds here as nvcc does beside the kernels): every frame above,
  the corrupt and truncated ones, CRC32C, the committed corpus
  (`tests/torch_fixtures/zstd/`, which covers every mode) and whole step
  reads equal to the plain decoder's, a bad frame a torn step.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import zstandard

import singa_tpu.utils.checkpoint as jckpt

from singa_tpu_torch.ops import _kernels
from singa_tpu_torch.utils import zstd
from singa_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              OrbaxTornStepError,
                                              OrbaxUnreadableError)
from singa_tpu_torch.utils.ocdbt import (BTREE_MAGIC, MANIFEST_MAGIC,
                                         OcdbtStore, decode_envelope)
from singa_tpu_torch.utils.zarr import read_array

pytestmark = pytest.mark.port
PLAIN = zstd.Codec(native=False)
FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures", "orbax")
LEVELS = (-5, 1, 3, 9, 19)
# every mode the plain decoder counts that a frame must be able to take
MODES = ("block.raw", "block.rle", "block.compressed", "literals.raw",
         "literals.rle", "literals.compressed", "literals.treeless",
         "literals.streams.1", "literals.streams.4", "huffman.fse",
         "huffman.direct", "table.predefined", "table.rle", "table.fse",
         "table.repeat")


@pytest.fixture(autouse=True)
def _hide_tensorstore(monkeypatch):
    """The port runs where tensorstore is not installed: an import of it
    fails (the oracle's module object stays bound in this file)."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)


def _rle_literals():
    """u32 words whose second 128 KiB block is copies of earlier random
    pieces, each after a 0x55 byte never seen before them: that block's
    literals are all 0x55, which libzstd stores as RLE literals."""
    rng = np.random.default_rng(1)
    pool = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(200)]
    head = b"".join(b"\xaa" + p for p in pool)
    filler = rng.integers(0, 256, zstd.BLOCK_MAX - len(head),
                          dtype=np.uint8).tobytes()
    tail = b"".join(b"\x55" + pool[j] for j in rng.integers(0, 200, 7000))
    data = head + filler + tail
    return np.frombuffer(data[:len(data) // 4 * 4], np.uint32)


def _arrays():
    rng = np.random.default_rng(0)
    big = rng.standard_normal(70000).astype(np.float32) * 0.02
    return {
        "rle_literals": _rle_literals(),
        "zeros": np.zeros(100000, np.float32),
        "ramp": np.arange(50000, dtype=np.float32),
        "rows": np.tile(rng.standard_normal(64).astype(np.float32),
                        (256, 1)),
        "rand_f32": rng.standard_normal((100, 200)).astype(np.float32),
        "rand_bf16": rng.standard_normal((300, 200)).astype(
            ml_dtypes.bfloat16),
        "rand_u32": rng.integers(0, 2 ** 32, 70000, dtype=np.uint32),
        "big_f32": big,
        "tiny": np.arange(5, dtype=np.int32),
        "ints": rng.integers(-3, 4, 60000).astype(np.int32),
    }


def _ts_zarr(path, arr, **metadata):
    meta = {"shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": "bfloat16" if arr.dtype == ml_dtypes.bfloat16
            else arr.dtype.str, **metadata}
    ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": path},
             "metadata": meta}, create=True).result().write(arr).result()


@pytest.fixture(scope="module")
def ts_frames(tmp_path_factory):
    """[(level, name, chunk file bytes, the array's bytes)] of every
    array written by tensorstore at every level."""
    root = tmp_path_factory.mktemp("frames")
    out = []
    for level in LEVELS:
        for name, arr in _arrays().items():
            path = str(root / f"{name}_{level}")
            _ts_zarr(path, arr, compressor={"id": "zstd", "level": level})
            chunk = "0" if arr.ndim == 1 else "0.0"
            with open(os.path.join(path, chunk), "rb") as f:
                out.append((level, name, f.read(), arr.tobytes()))
    return out


def test_zstd_decodes_every_frame_tensorstore_writes_and_takes_every_mode(
        ts_frames):
    counts = Counter()
    for level, name, frame, want in ts_frames:
        got = zstd.decompress(frame, counts)
        assert got == want, (level, name)
        size = zstd.content_size(frame)
        assert size in (None, len(want)), (level, name)
    # a frame spanning several blocks
    assert any(len(w) > 3 * zstd.BLOCK_MAX for _, _, _, w in ts_frames)
    missing = [m for m in MODES if counts[m] == 0]
    assert not missing, (missing, counts)
    assert counts["frame.windowed"] == len(ts_frames)
    assert counts["offset.repeat0"] and counts["offset.repeat1"]


@pytest.mark.parametrize("level", [1, 19])
def test_zstd_checks_the_content_checksum_and_skips_skippable_frames(level):
    data = _arrays()["big_f32"].tobytes()[:150000] + bytes(30000)
    framed = zstandard.ZstdCompressor(level=level,
                                      write_checksum=True).compress(data)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    counts = Counter()
    both = skippable + framed + framed
    assert zstd.decompress(both, counts) == data + data
    assert counts["frame.checksum"] == 2 and counts["frame.skippable"] == 1
    assert zstd.content_size(both) == 2 * len(data)
    bad = bytearray(framed)
    bad[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(bad))


def test_xxh64_and_crc32c_match_their_published_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.crc32c(b"123456789") == 0xE3069283
    data = _arrays()["rand_f32"].tobytes()[:4099]
    # libzstd's checksum is XXH64's low 32 bits, little-endian, last
    framed = zstandard.ZstdCompressor(level=1,
                                      write_checksum=True).compress(data)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(framed[-4:],
                                                          "little")


def test_zstd_refuses_a_dictionary_by_name():
    raw = b"abc" * 10
    # frame header: dictionary id flag 1 (one byte, id 7), single segment,
    # content size 30 in one byte; one raw last block
    frame = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x21, 7, len(raw)])
             + ((len(raw) << 3) | 1).to_bytes(3, "little") + raw)
    with pytest.raises(zstd.ZstdError, match="dictionary 7"):
        zstd.decompress(frame)
    plain = frame[:4] + bytes([0x20, len(raw)]) + frame[7:]
    assert zstd.decompress(plain) == raw


@pytest.mark.parametrize("cut", ["header", "block", "half", "flip"])
def test_zstd_raises_its_own_error_on_truncated_and_corrupt_frames(
        ts_frames, cut):
    frames = [f for lvl, name, f, _ in ts_frames
              if name in ("big_f32", "ints", "rand_bf16")]
    for frame in frames:
        bad = bytearray(frame)
        if cut == "header":
            bad = bad[:5]
        elif cut == "block":
            bad = bad[:len(bad) - 1]
        elif cut == "half":
            bad = bad[:len(bad) // 2]
        else:
            # the first block's header: its type becomes "reserved"
            bad[_first_block(frame)] |= 0x06
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))


def _first_block(frame: bytes) -> int:
    """Offset of the first block header of a frame (no dictionary)."""
    fhd = frame[4]
    single = (fhd >> 5) & 1
    return 5 + (1 - single) + (single, 2, 4, 8)[fhd >> 6]


# -- OCDBT ------------------------------------------------------------------

def _jax_step(ws, step=7, **handler_kw):
    """A step the JAX stack writes: the JAX package's CheckpointManager
    (orbax defaults) or, with `handler_kw`, orbax's PyTree handler with
    those options; f32, bf16, int32 and scalar leaves, one leaf of
    several zstd blocks."""
    rng = np.random.default_rng(step)
    params = {"fc/w": jnp.asarray(rng.standard_normal((40, 50)), jnp.float32),
              "fc/b": jnp.zeros(50, jnp.float32),
              "emb": jnp.asarray(rng.standard_normal((300, 200)),
                                 jnp.bfloat16),
              "big": jnp.asarray(rng.standard_normal(90000) * 0.01,
                                 jnp.float32),
              "ids": jnp.arange(37, dtype=jnp.int32)}
    opt = {"history": {k: v * 0.5 for k, v in params.items()
                       if v.dtype != jnp.int32},
           "count": jnp.asarray(3, jnp.int32)}
    if not handler_kw:
        jckpt.CheckpointManager(ws, log_fn=lambda s: None).save(
            step, params, opt)
        return
    mgr = ocp.CheckpointManager(
        os.path.join(ws, "checkpoints"),
        item_handlers=ocp.PyTreeCheckpointHandler(**handler_kw))
    mgr.save(step, args=ocp.args.PyTreeSave(
        {"params": params, "opt_state": opt, "step": np.asarray(step)}))
    mgr.wait_until_finished()
    with open(os.path.join(ws, "checkpoints", "LAYOUT_VERSION"), "w") as f:
        f.write(str(jckpt.LAYOUT_VERSION))


@pytest.fixture(scope="module")
def jax_ws(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ocdbt_ws"))
    _jax_step(ws)
    return ws


def _ts_kv(root):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": {"driver": "file",
                                     "path": root + "/"}}).result()


def _same_store(root):
    kv = _ts_kv(root)
    want = sorted(k.decode() for k in kv.list().result())
    mine = OcdbtStore(root, PLAIN)
    assert mine.list() == want
    assert want
    for k in want:
        assert mine.read(k) == kv.read(k).result().value, k
    prefix = want[len(want) // 2].split("/")[0] + "/"
    assert mine.list(prefix) == [k for k in want if k.startswith(prefix)]
    assert mine.read("no/such/key") is None
    return mine


def test_ocdbt_equals_tensorstore_on_a_jax_step_and_its_process_files(
        jax_ws):
    top = os.path.join(jax_ws, "checkpoints", "7", "default")
    mine = _same_store(top)
    assert mine.max_inline_value_bytes == 1024
    entries = mine._all()
    inline = [k for k, v in entries.items() if isinstance(v, bytes)]
    indirect = {v[0] for v in entries.values() if not isinstance(v, bytes)}
    assert inline and indirect
    # the top-level tree refers into the per-process database
    assert all(base == "ocdbt.process_0/" for base, _ in indirect)
    _same_store(os.path.join(top, "ocdbt.process_0"))


@pytest.mark.parametrize("arity,node_bytes", [(1, 256), (4, 600)])
def test_ocdbt_equals_tensorstore_over_interior_and_version_tree_nodes(
        tmp_path, arity, node_bytes):
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": {"driver": "file", "path": root + "/"},
        "config": {"max_decoded_node_bytes": node_bytes,
                   "max_inline_value_bytes": 64,
                   "version_tree_arity_log2": arity}}).result()
    for g in range(40):
        kv[f"k/{g % 13:03d}/{g:04d}"] = bytes([g]) * (3 if g % 3 else 500)
    dump = ts.ocdbt.dump(ts.KvStore.open(
        {"driver": "file", "path": root + "/"}).result()).result()
    assert dump["version_tree_nodes"]
    assert max(v["root_height"] for v in dump["versions"]) > 0
    mine = _same_store(root)
    assert mine.generation == max(v["generation_number"]
                                  for v in dump["versions"])
    # the newest version through the version tree alone
    assert mine._latest([], [(n["generation_number"], mine_ref, n["height"])
                             for n, mine_ref in _node_refs(mine, dump)]
                        )[0] == max(n["generation_number"]
                                    for n in dump["version_tree_nodes"])


def test_an_empty_latest_version_lists_no_keys(tmp_path):
    root = str(tmp_path / "db")
    kv = _ts_kv(root)
    kv["a"] = b"1"
    del kv["a"]
    mine = OcdbtStore(root, PLAIN)
    assert mine.generation == 3
    assert mine.list() == [] and mine.read("a") is None


def _node_refs(mine, dump):
    out = []
    for n in dump["version_tree_nodes"]:
        _, _, path, off, length = n["location"].split(":")
        out.append((n, (("", path), int(off), int(length))))
    return out


def _flip(path, at, mask=0x10):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ mask]))


def _copy(src, tmp_path):
    dst = str(tmp_path / "ws")
    shutil.copytree(src, dst)
    return dst


def _node_files(top):
    """The data files of the database at `top` itself (not of its
    per-process databases) that begin with a B+tree node: the nodes of
    its latest version."""
    out = []
    for f in sorted(os.listdir(os.path.join(top, "d"))):
        p = os.path.join(top, "d", f)
        with open(p, "rb") as fh:
            if int.from_bytes(fh.read(4), "big") == BTREE_MAGIC:
                out.append(p)
    return out


def test_a_flipped_byte_in_a_node_or_manifest_is_a_torn_step(jax_ws,
                                                              tmp_path):
    ws = _copy(jax_ws, tmp_path)
    top = os.path.join(ws, "checkpoints", "7", "default")
    node = _node_files(top)[0]
    _flip(node, os.path.getsize(node) // 2)
    with pytest.raises(OrbaxTornStepError, match="CRC32C"):
        OcdbtStore(top, PLAIN)
    man = os.path.join(top, "manifest.ocdbt")
    _flip(man, 20)
    with pytest.raises(OrbaxTornStepError):
        OcdbtStore(top, PLAIN)
    with open(man, "r+b") as f:
        f.truncate(os.path.getsize(man) - 3)
    with pytest.raises(OrbaxTornStepError):
        OcdbtStore(top, PLAIN)


def _reseal(path, edit):
    """Rewrite the encoded file at `path` with `edit` applied to its
    version and compression bytes, sealed again with a good CRC32C."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    edit(data)
    data[-4:] = zstd.crc32c(bytes(data[:-4])).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("field,match", [(12, "format version 3"),
                                         (13, "compression id 5")])
def test_an_unknown_format_version_or_compression_is_refused_by_name(
        jax_ws, tmp_path, field, match):
    ws = _copy(jax_ws, tmp_path)
    top = os.path.join(ws, "checkpoints", "7", "default")

    def edit(d):
        d[field] = 3 if field == 12 else 5
    _reseal(os.path.join(top, "manifest.ocdbt"), edit)
    with pytest.raises(OrbaxUnreadableError, match=match):
        OcdbtStore(top, PLAIN)
    mgr = CheckpointManager(ws, log_fn=lambda s: None, device="cpu")
    with pytest.raises(OrbaxUnreadableError, match=match):
        mgr.restore()


def test_the_envelope_reads_as_tensorstore_wrote_it(jax_ws):
    top = os.path.join(jax_ws, "checkpoints", "7", "default")
    with open(os.path.join(top, "manifest.ocdbt"), "rb") as f:
        data = f.read()
    assert data[:4] == bytes.fromhex("0cdb3a2a")
    assert int.from_bytes(data[4:12], "little") == len(data)
    assert data[12:14] == b"\x00\x01" and data[14:18] == bytes.fromhex(
        "28b52ffd")
    body = decode_envelope(data, MANIFEST_MAGIC, "manifest", PLAIN)
    assert len(body) == zstd.content_size(data[14:-4])
    counts = Counter()
    zstd.decompress(data[14:-4], counts)
    assert counts["frame.single_segment"] == 1


# -- zarr -------------------------------------------------------------------

ZARR_V2 = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32,
           "<i8": np.int64, "<u4": np.uint32, "|b1": np.bool_,
           "bfloat16": ml_dtypes.bfloat16}
ZARR_V3 = {"float32": np.float32, "float16": np.float16, "int32": np.int32,
           "int64": np.int64, "uint32": np.uint32, "bool": np.bool_,
           "bfloat16": ml_dtypes.bfloat16}


def _sample(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.3
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 1000, shape).astype(dtype)
    return (rng.standard_normal(shape) * 3).astype(dtype)


def _want(arr):
    arr = np.asarray(arr)
    return arr.astype(np.float32) if arr.dtype == ml_dtypes.bfloat16 else arr


def _check(store, path, want):
    got = read_array(store, path, PLAIN)
    want = _want(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("kv", ["ocdbt", "file"])
def test_zarr_v2_reads_equal_tensorstore_for_every_dtype_and_layout(
        tmp_path, kv):
    root = str(tmp_path / "db")
    base = {"driver": "file", "path": root + "/"}
    layouts = [{"order": "C", "compressor": {"id": "zstd", "level": 3}},
               {"order": "F", "dimension_separator": "/",
                "compressor": {"id": "zlib", "level": 1}},
               {"order": "C", "compressor": {"id": "gzip", "level": 1}},
               {"order": "C", "compressor": None}]
    wants = {}
    for i, (name, dt) in enumerate(ZARR_V2.items()):
        for j, layout in enumerate(layouts):
            path = f"a{i}_{j}"
            arr = _sample(dt, (37, 23), i * 10 + j)
            store = ({"driver": "ocdbt", "base": base, "path": path + "/"}
                     if kv == "ocdbt" else
                     {"driver": "file", "path": f"{root}/{path}/"})
            t = ts.open({"driver": "zarr", "kvstore": store,
                         "metadata": {"shape": [37, 23], "chunks": [16, 10],
                                      "dtype": name, "fill_value": None
                                      if j % 2 else dt(0).item(),
                                      **layout}},
                        create=True).result()
            # the last row of chunks stays unwritten: fill value
            t[:32].write(arr[:32]).result()
            arr = arr.copy()
            arr[32:] = 0
            wants[path] = np.asarray(t.read().result())
            np.testing.assert_array_equal(_want(wants[path]), _want(arr))
    mine = OcdbtStore(root, PLAIN) if kv == "ocdbt" else _files(root)
    for path, want in wants.items():
        _check(mine, path, want)


def _files(root):
    from singa_tpu_torch.utils.ocdbt import FileStore
    return FileStore(root)


@pytest.mark.parametrize("kv", ["ocdbt", "file"])
def test_zarr3_sharded_reads_equal_tensorstore_for_every_dtype(tmp_path,
                                                               kv):
    root = str(tmp_path / "db")
    base = {"driver": "file", "path": root + "/"}
    inner = [{"name": "bytes", "configuration": {"endian": "little"}},
             {"name": "zstd", "configuration": {"level": 3,
                                                "checksum": False}}]
    variants = [
        # as orbax writes it: one shard a chunk, index at the end
        [{"name": "sharding_indexed",
          "configuration": {"chunk_shape": [8, 6], "codecs": inner,
                            "index_codecs": [
                                {"name": "bytes",
                                 "configuration": {"endian": "little"}},
                                {"name": "crc32c"}]}}],
        # index at the start, big-endian inner bytes with a CRC32C
        [{"name": "sharding_indexed",
          "configuration": {"chunk_shape": [4, 6], "index_location":
                            "start", "codecs": [
                                {"name": "bytes",
                                 "configuration": {"endian": "big"}},
                                {"name": "crc32c"}]}}],
        # a transpose, then bytes and zstd, no sharding; v2 chunk keys
        [{"name": "transpose", "configuration": {"order": [1, 0]}},
         *inner],
    ]
    wants = {}
    for i, (name, dt) in enumerate(ZARR_V3.items()):
        for j, codecs in enumerate(variants):
            path = f"b{i}_{j}"
            arr = _sample(dt, (21, 13), 100 + i * 10 + j)
            store = ({"driver": "ocdbt", "base": base, "path": path + "/"}
                     if kv == "ocdbt" else
                     {"driver": "file", "path": f"{root}/{path}/"})
            meta = {"shape": [21, 13], "data_type": name,
                    "chunk_grid": {"name": "regular", "configuration":
                                   {"chunk_shape": [16, 12]}},
                    "codecs": codecs}
            if j == 2:
                meta["chunk_key_encoding"] = {"name": "v2"}
            t = ts.open({"driver": "zarr3", "kvstore": store,
                         "metadata": meta}, create=True).result()
            # inner chunks and whole chunks left unwritten: fill value
            t[:9, :7].write(arr[:9, :7]).result()
            t[16:, :].write(arr[16:, :]).result()
            wants[path] = np.asarray(t.read().result())
    mine = OcdbtStore(root, PLAIN) if kv == "ocdbt" else _files(root)
    for path, want in wants.items():
        _check(mine, path, want)


def test_zarr_refuses_an_unknown_codec_dtype_or_filter_by_name(tmp_path):
    root = str(tmp_path / "db")
    store = _files(root)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for path, meta, match in (
            ("blosc", {"compressor": {"id": "blosc"}}, "compressor 'blosc'"),
            ("f64", {"dtype": "<f8"}, "dtype '<f8'"),
            ("filt", {"filters": [{"id": "delta", "dtype": "<f4"}]},
             "filters")):
        os.makedirs(os.path.join(root, path))
        doc = {"zarr_format": 2, "shape": [3, 4], "chunks": [3, 4],
               "dtype": "<f4", "compressor": None, "fill_value": 0,
               "order": "C", "filters": None, **meta}
        with open(os.path.join(root, path, ".zarray"), "w") as f:
            json.dump(doc, f)
        with open(os.path.join(root, path, "0.0"), "wb") as f:
            f.write(arr.tobytes())
        with pytest.raises(OrbaxUnreadableError, match=match):
            read_array(store, path, PLAIN)
    os.makedirs(os.path.join(root, "v3"))
    with open(os.path.join(root, "v3", "zarr.json"), "w") as f:
        json.dump({"zarr_format": 3, "node_type": "array", "shape": [3, 4],
                   "data_type": "float32",
                   "chunk_grid": {"name": "regular", "configuration":
                                  {"chunk_shape": [3, 4]}},
                   "codecs": [{"name": "bytes"}, {"name": "blosc"}],
                   "fill_value": 0}, f)
    with pytest.raises(OrbaxUnreadableError, match="codec 'blosc'"):
        read_array(store, "v3", PLAIN)


# -- whole restores ---------------------------------------------------------

def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}|")
        else:
            yield f"{prefix}{k}", tree[k]


def _equal_to_jax_restore(ws):
    mine = CheckpointManager(ws, log_fn=lambda s: None, device="cpu")
    p, o, s = mine.restore()
    jp, jo, js = jckpt.CheckpointManager(ws, log_fn=lambda s: None).restore()
    assert s == js
    got = dict(_flat({"params": p, "opt_state": o}))
    want = dict(_flat({"params": jp, "opt_state": jo}))
    assert set(got) == set(want)
    for k, w in want.items():
        w = _want(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    return got


@pytest.mark.parametrize("options", [{}, {"use_zarr3": True},
                                     {"use_ocdbt": False},
                                     {"use_zarr3": True, "use_ocdbt": False}],
                         ids=["zarr2_ocdbt", "zarr3_ocdbt", "zarr2_files",
                              "zarr3_files"])
def test_restore_equals_the_jax_restore_in_every_layout(tmp_path, options):
    ws = str(tmp_path / "ws")
    _jax_step(ws, **options)
    got = _equal_to_jax_restore(ws)
    assert got["params|emb"].dtype == np.float32      # bf16, widened
    assert got["params|ids"].dtype == np.int32
    assert got["opt_state|count"].shape == ()
    assert got["params|big"].nbytes > 2 * zstd.BLOCK_MAX


def _torn_leaf_frame(top):
    """(path, offset) of a byte inside the zstd frame of the largest
    indirect value of the step at `top`."""
    mine = OcdbtStore(top, PLAIN)
    (base, rel), off, length = max(
        (v for v in mine._all().values() if not isinstance(v, bytes)),
        key=lambda v: v[2])
    return os.path.join(top, base, rel), off


@pytest.mark.parametrize("tear", ["node", "frame", "truncated"])
def test_a_torn_step_is_walked_past_to_the_older_one(tmp_path, capsys,
                                                     tear):
    ws = str(tmp_path / "ws")
    _jax_step(ws, step=5)
    _jax_step(ws, step=7)
    top = os.path.join(ws, "checkpoints", "7", "default")
    if tear == "node":
        node = _node_files(top)[-1]
        _flip(node, os.path.getsize(node) - 9)
    elif tear == "frame":
        path, off = _torn_leaf_frame(top)
        _flip(path, off + 4, 0x08)    # the frame header's reserved bit
    else:
        path, off = _torn_leaf_frame(top)
        with open(path, "r+b") as f:
            f.truncate(off + 100)
    mgr = CheckpointManager(ws, device="cpu")
    with pytest.raises(OrbaxTornStepError):
        from singa_tpu_torch.utils.checkpoint import _read_orbax
        _read_orbax(os.path.join(ws, "checkpoints", "7"), PLAIN)
    assert mgr.restore()[2] == 5
    assert "checkpoint step 7 is corrupt" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["lm_tiny", "conv"])
def test_the_fixtures_equal_the_jax_restore_and_their_hashes(tmp_path,
                                                             name):
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        rec = json.load(f)[name]
    ws = _copy(os.path.join(FIXTURES, name), tmp_path)
    got = _equal_to_jax_restore(ws)
    assert set(got) == set(rec["leaves"])
    for k, v in got.items():
        d = rec["leaves"][k]
        assert [v.dtype.str, list(v.shape)] == [d["dtype"], d["shape"]], k
        assert hashlib.sha256(np.ascontiguousarray(v).tobytes()
                              ).hexdigest() == d["sha256"], k
    assert CheckpointManager(ws, device="cpu").latest_step() == rec["step"]


def test_a_step_two_processes_wrote_restores_to_its_hashes(tmp_path):
    """`lm_tiny_tp2`: the JAX CLI's step of lm_tiny.conf under
    tensor_parallel: 2 on 2 processes, whose model-sharded leaves are
    split between `ocdbt.process_0/` and `ocdbt.process_1/`, restores in
    the port to the sha256 of the JAX restore (with its trainer's tree
    as template) of every leaf, and equals tensorstore key for key."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        rec = json.load(f)["lm_tiny_tp2"]
    ws = _copy(os.path.join(FIXTURES, "lm_tiny_tp2"), tmp_path)
    default = os.path.join(ws, "checkpoints", str(rec["step"]), "default")
    assert os.path.isdir(os.path.join(default, "ocdbt.process_1", "d"))
    store = OcdbtStore(default, PLAIN)
    assert {f[0][0] for f in store._entries.values()
            if isinstance(f, tuple)} >= {"ocdbt.process_0/",
                                         "ocdbt.process_1/"}
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{default}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert keys == store.list()
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    p, o, step = CheckpointManager(ws, device="cpu").restore()
    assert step == rec["step"]
    got = {f"params|{k}": v for k, v in p.items()}
    got.update({f"opt_state|{s}|{k}": v for s, d in o.items()
                for k, v in d.items()})
    assert set(got) == set(rec["leaves"])
    for k, v in got.items():
        d = rec["leaves"][k]
        assert [v.dtype.str, list(v.shape)] == [d["dtype"], d["shape"]], k
        assert hashlib.sha256(np.ascontiguousarray(v).tobytes()
                              ).hexdigest() == d["sha256"], k


# -- the native decoder (csrc/zstd_dec.cu), built with g++ -------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "singa_tpu_torch", "csrc", "zstd_dec.cu")
CORPUS = os.path.join(os.path.dirname(__file__), "torch_fixtures", "zstd")


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """`Codec(native=True)` over `csrc/zstd_dec.cu` compiled by g++: the
    source is host code, so the host compiler builds the decoder that
    nvcc builds beside the kernels on the card's machine."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/zstd_dec.cu")
    so = str(tmp_path_factory.mktemp("zstd_dec") / "zstd_dec.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O3", "-shared",
                    "-fPIC", CSRC, "-o", so], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_libs", {"zstd_dec": ctypes.CDLL(so)})
        mp.setattr(_kernels, "_entries", {})
        yield zstd.Codec(native=True)


def test_native_decoder_equals_plain_and_tensorstore_on_every_frame(
        ts_frames, native):
    _kernels.reset_launches()
    for level, name, frame, want in ts_frames:
        assert bytes(native.decompress(frame)) == want, (level, name)
        assert bytes(native.decompress(frame, len(want))) == want
        with pytest.raises(zstd.ZstdError):
            native.decompress(frame, len(want) + 1)
    assert _kernels.CALLS["zstd_dec"] == 3 * len(ts_frames)
    data = _arrays()["big_f32"].tobytes()[:150000] + bytes(30000)
    framed = zstandard.ZstdCompressor(level=19,
                                      write_checksum=True).compress(data)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    both = skippable + framed + framed
    assert bytes(native.decompress(both)) == zstd.decompress(both) == 2 * data
    bad = bytearray(framed)
    bad[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        native.decompress(bytes(bad))
    raw = b"abc" * 10
    dictionary = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x21, 7, 30])
                  + ((30 << 3) | 1).to_bytes(3, "little") + raw)
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        native.decompress(dictionary)
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == zstd.crc32c(b"") == 0
    for _, _, frame, _ in ts_frames[:4]:
        assert native.crc32c(frame) == zstd.crc32c(frame)


@pytest.mark.parametrize("cut", ["header", "block", "half", "flip"])
def test_native_decoder_raises_on_truncated_and_corrupt_frames(
        ts_frames, native, cut):
    frames = [f for lvl, name, f, _ in ts_frames
              if name in ("big_f32", "ints", "rand_bf16")]
    for frame in frames:
        bad = bytearray(frame)
        if cut == "header":
            bad = bad[:5]
        elif cut == "block":
            bad = bad[:len(bad) - 1]
        elif cut == "half":
            bad = bad[:len(bad) // 2]
        else:
            bad[_first_block(frame)] |= 0x06
        with pytest.raises(zstd.ZstdError):
            native.decompress(bytes(bad))


def test_the_committed_corpus_takes_every_mode_and_decodes_to_its_hashes(
        native):
    """The frames `chip_smoke.py` phase 18a decodes on the card."""
    with open(os.path.join(CORPUS, "corpus.json")) as f:
        corpus = json.load(f)
    counts = Counter()
    for name, rec in sorted(corpus.items()):
        with open(os.path.join(CORPUS, name), "rb") as f:
            frame = f.read()
        plain = zstd.decompress(frame, counts)
        assert len(plain) == rec["size"], name
        assert hashlib.sha256(plain).hexdigest() == rec["sha256"], name
        assert bytes(native.decompress(frame)) == plain, name
    missing = [m for m in MODES if counts[m] == 0]
    assert not missing, (missing, counts)
    assert counts["frame.checksum"] and counts["frame.skippable"]


@pytest.mark.parametrize("options", [{}, {"use_zarr3": True}],
                         ids=["zarr2", "zarr3"])
def test_a_native_read_equals_the_plain_one_and_tears_on_a_bad_frame(
        tmp_path, native, options):
    from singa_tpu_torch.utils.checkpoint import _read_orbax
    ws = str(tmp_path / "ws")
    _jax_step(ws, **options)
    stepdir = os.path.join(ws, "checkpoints", "7")
    got = dict(_flat(_read_orbax(stepdir, native)))
    want = dict(_flat(_read_orbax(stepdir, PLAIN)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    # the largest leaf's value starts with a frame (in zarr3, its shard's
    # first inner chunk): the frame header's reserved bit
    path, off = _torn_leaf_frame(os.path.join(stepdir, "default"))
    _flip(path, off + 4, 0x08)
    with pytest.raises(OrbaxTornStepError, match="zstd_dec: error"):
        _read_orbax(stepdir, native)
