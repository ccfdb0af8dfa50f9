"""zarr arrays (v2 and v3) over a key-value store, read into numpy.

Orbax stores each leaf of a step as a zarr array at the leaf's key path
joined with `.` (`params.fc/w`), in the step's OCDBT database
(`utils/ocdbt.py`) or, for a step written with `use_ocdbt: false`, in
plain files.  `read_array(store, path, codec)` reads one such array
whole, with a `Codec` (`utils/zstd.py`) for its zstd frames and its
CRC32C.

- v2 (`.zarray`): dtypes `<f4`, `<f2`, `<i4`, `<i8`, `<u4`, `|b1` and
  `bfloat16`; `order` C or F; `dimension_separator` `.` or `/`;
  compressor `zstd`, `zlib`, `gzip` or none; no filters; a missing
  chunk takes `fill_value` (0 where it is null).
- v3 (`zarr.json`): the same types by their v3 names; the `default` and
  `v2` chunk key encodings; the codecs `bytes` (either endian),
  `transpose`, `zstd`, `crc32c` and `sharding_indexed` (its
  index of (offset, nbytes) pairs at the end or the start of the shard,
  decoded through its own codecs; an inner chunk that was never written
  takes the fill value).

`v2_entries(path, array, dtype_name)` is the writer's side: the
`.zarray` and the one chunk of an array stored whole (orbax's chunk for a
leaf on one device), in a zstd frame of Raw blocks, as the key-value
pairs to put into a store.

The chunk grid is assembled into one numpy array.  bfloat16 comes back
as float32, widened by a 16-bit shift, which holds every bf16 value
exactly.  Another codec, filter, dtype or layout raises
`OrbaxUnreadableError` naming it; a missing metadata file, a chunk that
does not decode or a CRC32C that does not match raises
`OrbaxTornStepError`.
"""

from __future__ import annotations

import gzip
import itertools
import json
import math
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ocdbt import OrbaxTornStepError, OrbaxUnreadableError
from .zstd import Codec, ZstdError, raw_frame

# stored dtype name -> (numpy dtype of the stored bytes, little-endian)
V2_DTYPES = {"<f4": "<f4", "<f2": "<f2", "<i4": "<i4", "<i8": "<i8",
             "<u4": "<u4", "|b1": "|b1", "bfloat16": "<u2"}
V3_DTYPES = {"float32": "<f4", "float16": "<f2", "int32": "<i4",
             "int64": "<i8", "uint32": "<u4", "bool": "|b1",
             "bfloat16": "<u2"}
_MISSING = (1 << 64) - 1        # a sharded index entry never written


def _widen(a: np.ndarray, bf16: bool) -> np.ndarray:
    """Stored values as the array `read_array` returns: bfloat16 bits
    shifted into the top half of float32, the rest in native order."""
    if bf16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(a.dtype.newbyteorder("="), copy=False)


def _fill(value, dtype: np.dtype, bf16: bool):
    """A metadata fill value as a scalar of `dtype` (bf16: its bits)."""
    if value is None:
        return dtype.type(0)
    if isinstance(value, str):
        named = {"NaN": math.nan, "Infinity": math.inf,
                 "-Infinity": -math.inf}.get(value)
        if named is None:
            raise OrbaxUnreadableError(f"fill value {value!r}")
        value = named
    if bf16:
        f32 = np.array(value, np.float32).view(np.uint32)
        return np.uint16(int(f32) >> 16)
    return dtype.type(value)


def _chunk_grid(shape: Sequence[int], chunks: Sequence[int]):
    return itertools.product(*(range(-(-s // c)) for s, c in
                               zip(shape, chunks)))


def _place(out: np.ndarray, idx: Tuple[int, ...], chunks: Sequence[int],
           chunk: np.ndarray) -> None:
    region = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, out.shape))
    out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]


def _json(store, key: str) -> Optional[dict]:
    raw = store.read(key)
    if raw is None:
        return None
    try:
        doc = json.loads(bytes(raw))
    except ValueError as e:
        raise OrbaxTornStepError(f"{key} does not parse ({e})") from e
    if not isinstance(doc, dict):
        raise OrbaxTornStepError(f"{key} is not a JSON object")
    return doc


def read_array(store, path: str, codec: Codec) -> np.ndarray:
    """The zarr array at `path` (a key prefix, no trailing `/`) of
    `store`, whole."""
    for name, read in ((".zarray", _read_v2), ("zarr.json", _read_v3)):
        meta = _json(store, f"{path}/{name}")
        if meta is None:
            continue
        try:
            return read(store, path, meta, codec)
        except (KeyError, TypeError, AttributeError) as e:
            raise OrbaxUnreadableError(f"zarr array {path!r}: metadata "
                                       f"{name} lacks or misstates a "
                                       f"field ({e!r})") from e
    raise OrbaxTornStepError(f"no zarr array at {path!r}: neither "
                             f"{path}/.zarray nor {path}/zarr.json")


# -- v2 ---------------------------------------------------------------------

def _read_v2(store, path: str, meta: dict, codec: Codec) -> np.ndarray:
    where = f"zarr array {path!r}"
    name = meta.get("dtype")
    if name not in V2_DTYPES:
        raise OrbaxUnreadableError(f"{where}: zarr v2 dtype {name!r}")
    if meta.get("filters"):
        raise OrbaxUnreadableError(f"{where}: zarr v2 filters "
                                   f"{meta['filters']!r}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxUnreadableError(f"{where}: zarr v2 order {order!r}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxUnreadableError(f"{where}: dimension separator {sep!r}")
    comp = meta.get("compressor")
    cid = None if comp is None else comp.get("id")
    if cid not in (None, "zstd", "zlib", "gzip"):
        raise OrbaxUnreadableError(f"{where}: zarr v2 compressor {cid!r}")
    shape = [int(s) for s in meta["shape"]]
    chunks = [int(c) for c in meta["chunks"]]
    dtype = np.dtype(V2_DTYPES[name])
    bf16 = name == "bfloat16"
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    nbytes = math.prod(chunks) * dtype.itemsize
    for idx in _chunk_grid(shape, chunks):
        key = f"{path}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = store.read(key)
        if raw is None:
            continue
        try:
            if cid == "zstd":
                raw = codec.decompress(raw, nbytes)
            elif cid == "zlib":
                raw = zlib.decompress(raw)
            elif cid == "gzip":
                raw = gzip.decompress(raw)
        except (ZstdError, zlib.error, OSError, EOFError) as e:
            raise OrbaxTornStepError(f"{where}: chunk {key!r} does not "
                                     f"decode ({e})") from e
        if len(raw) != nbytes:
            raise OrbaxTornStepError(f"{where}: chunk {key!r} holds "
                                     f"{len(raw)} bytes, {nbytes} expected")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        _place(out, idx, chunks, chunk)
    return _widen(out, bf16)


def v2_entries(path: str, array: np.ndarray, dtype_name: str) -> list:
    """[(key, parts)] of the zarr v2 array at `path` holding `array`
    (C order, its stored bytes: a bfloat16 array as its uint16 bits) as
    one chunk, compressor zstd (a frame of Raw blocks), as tensorstore
    writes them for orbax: sorted compact JSON, fill value null."""
    if V2_DTYPES.get(dtype_name) != array.dtype.str:
        raise ValueError(f"zarr v2 dtype {dtype_name!r} does not store a "
                         f"{array.dtype.str} array")
    shape = list(array.shape)
    meta = {"chunks": [max(s, 1) for s in shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype_name,
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    out = [(f"{path}/.zarray",
            [json.dumps(meta, sort_keys=True, separators=(",", ":"))
             .encode()])]
    if array.size:
        key = ".".join("0" for _ in shape) or "0"
        out.append((f"{path}/{key}",
                    raw_frame(np.ascontiguousarray(array).reshape(-1)
                              .view(np.uint8).data)))
    return out


# -- v3 ---------------------------------------------------------------------

class _V3Chain:
    """A v3 codec chain split into its array->array codecs (transpose),
    its array->bytes codec (bytes, or sharding_indexed) and its
    bytes->bytes codecs (zstd, crc32c)."""

    def __init__(self, codecs: List[dict], where: str):
        self.where = where
        self.arrays: List[dict] = []
        self.to_bytes: Optional[dict] = None
        self.bytes: List[dict] = []
        for c in codecs:
            name = c.get("name")
            conf = c.get("configuration") or {}
            if name == "transpose":
                if self.to_bytes is not None:
                    raise OrbaxUnreadableError(f"{where}: transpose after "
                                               f"the array->bytes codec")
                self.arrays.append(conf)
            elif name in ("bytes", "sharding_indexed"):
                self.to_bytes = {"name": name, **conf}
            elif name in ("zstd", "crc32c"):
                if self.to_bytes is None:
                    raise OrbaxUnreadableError(f"{where}: {name} before the "
                                               f"array->bytes codec")
                self.bytes.append({"name": name, **conf})
            else:
                raise OrbaxUnreadableError(f"{where}: zarr v3 codec "
                                           f"{name!r}")
        if self.to_bytes is None:
            raise OrbaxUnreadableError(f"{where}: no array->bytes codec")

    def decode_bytes(self, raw, nbytes: Optional[int], codec: Codec,
                     key: str):
        """Undo the bytes->bytes codecs; `nbytes`, where known, is what
        the array->bytes codec takes."""
        try:
            for i, c in reversed(list(enumerate(self.bytes))):
                if c["name"] == "crc32c":
                    raw = bytes(raw)
                    if len(raw) < 4 or codec.crc32c(raw[:-4]) != \
                            int.from_bytes(raw[-4:], "little"):
                        raise OrbaxTornStepError(f"{self.where}: chunk "
                                                 f"{key!r} fails its CRC32C")
                    raw = raw[:-4]
                else:
                    raw = codec.decompress(raw, nbytes if i == 0 else None)
        except ZstdError as e:
            raise OrbaxTornStepError(f"{self.where}: chunk {key!r} does "
                                     f"not decode ({e})") from e
        return raw

    def decode(self, raw, shape: List[int], dtype: np.dtype, fill,
               codec: Codec, key: str) -> np.ndarray:
        """The chunk of `shape` (in the array's order) that `raw` holds."""
        # the shape the array->bytes codec sees: after the transposes
        inner = list(shape)
        perms = []
        for conf in self.arrays:
            order = conf.get("order")
            if sorted(order or []) != list(range(len(inner))):
                raise OrbaxUnreadableError(f"{self.where}: transpose order "
                                           f"{order!r}")
            perms.append(order)
            inner = [inner[o] for o in order]
        tb = self.to_bytes
        if tb["name"] == "bytes":
            nbytes = math.prod(inner) * dtype.itemsize
            raw = self.decode_bytes(raw, nbytes, codec, key)
            if len(raw) != nbytes:
                raise OrbaxTornStepError(f"{self.where}: chunk {key!r} "
                                         f"holds {len(raw)} bytes, {nbytes} "
                                         f"expected")
            endian = tb.get("endian", "little")
            if endian not in ("little", "big"):
                raise OrbaxUnreadableError(f"{self.where}: bytes endian "
                                           f"{endian!r}")
            dt = dtype.newbyteorder("<" if endian == "little" else ">") \
                if dtype.itemsize > 1 else dtype
            a = np.frombuffer(raw, dt).reshape(inner).astype(dtype)
        else:
            raw = self.decode_bytes(raw, None, codec, key)
            a = _shard(tb, bytes(raw), inner, dtype, fill, codec,
                       self.where, key)
        for order in reversed(perms):
            a = np.transpose(a, np.argsort(order))
        return a


def _shard(conf: dict, raw: bytes, shape: List[int], dtype: np.dtype, fill,
           codec: Codec, where: str, key: str) -> np.ndarray:
    """A `sharding_indexed` shard of `shape`: its index, then each inner
    chunk that was written, decoded through the inner codecs."""
    inner = [int(c) for c in conf["chunk_shape"]]
    if len(inner) != len(shape) or any(s % c for s, c in zip(shape, inner)):
        raise OrbaxUnreadableError(f"{where}: inner chunks {inner} do not "
                                   f"tile the shard {shape}")
    grid = [s // c for s, c in zip(shape, inner)]
    n = math.prod(grid)
    ichain = _V3Chain(conf.get("index_codecs")
                      or [{"name": "bytes",
                           "configuration": {"endian": "little"}},
                          {"name": "crc32c"}], f"{where} (shard index)")
    if ichain.arrays or ichain.to_bytes["name"] != "bytes" or any(
            c["name"] != "crc32c" for c in ichain.bytes):
        raise OrbaxUnreadableError(f"{where}: shard index codecs "
                                   f"{conf.get('index_codecs')!r}")
    isize = 16 * n + 4 * len(ichain.bytes)
    loc = conf.get("index_location", "end")
    if loc not in ("end", "start"):
        raise OrbaxUnreadableError(f"{where}: index location {loc!r}")
    if len(raw) < isize:
        raise OrbaxTornStepError(f"{where}: shard {key!r} shorter than its "
                                 f"index")
    ibytes = raw[-isize:] if loc == "end" else raw[:isize]
    index = ichain.decode(ibytes, grid + [2], np.dtype("<u8"), 0, codec,
                          f"{key} (index)").reshape(n, 2)
    chain = _V3Chain(conf.get("codecs") or [{"name": "bytes"}], where)
    out = np.full(shape, fill, dtype)
    for i, idx in enumerate(itertools.product(*(range(g) for g in grid))):
        off, nb = int(index[i, 0]), int(index[i, 1])
        if off == _MISSING and nb == _MISSING:
            continue
        if off + nb > len(raw):
            raise OrbaxTornStepError(f"{where}: shard {key!r} inner chunk "
                                     f"{idx} past the shard's end")
        chunk = chain.decode(raw[off:off + nb], inner, dtype, fill, codec,
                             f"{key}[{idx}]")
        _place(out, idx, inner, chunk)
    return out


def _read_v3(store, path: str, meta: dict, codec: Codec) -> np.ndarray:
    where = f"zarr array {path!r}"
    if meta.get("node_type", "array") != "array":
        raise OrbaxUnreadableError(f"{where}: zarr v3 node type "
                                   f"{meta.get('node_type')!r}")
    name = meta.get("data_type")
    if name not in V3_DTYPES:
        raise OrbaxUnreadableError(f"{where}: zarr v3 data type {name!r}")
    grid = meta.get("chunk_grid", {})
    if grid.get("name") != "regular":
        raise OrbaxUnreadableError(f"{where}: chunk grid "
                                   f"{grid.get('name')!r}")
    enc = meta.get("chunk_key_encoding", {"name": "default"})
    ename = enc.get("name")
    if ename not in ("default", "v2"):
        raise OrbaxUnreadableError(f"{where}: chunk key encoding {ename!r}")
    sep = (enc.get("configuration") or {}).get(
        "separator", "/" if ename == "default" else ".")
    shape = [int(s) for s in meta["shape"]]
    chunks = [int(c) for c in grid["configuration"]["chunk_shape"]]
    dtype = np.dtype(V3_DTYPES[name])
    bf16 = name == "bfloat16"
    fill = _fill(meta.get("fill_value"), dtype, bf16)
    chain = _V3Chain(meta.get("codecs", []), where)
    out = np.full(shape, fill, dtype)
    for idx in _chunk_grid(shape, chunks):
        if ename == "default":
            key = sep.join(["c"] + [str(i) for i in idx])
        else:
            key = sep.join(map(str, idx)) if idx else "0"
        raw = store.read(f"{path}/{key}")
        if raw is None:
            continue
        chunk = chain.decode(raw, chunks, dtype, fill, codec,
                             f"{path}/{key}")
        _place(out, idx, chunks, chunk)
    return _widen(out, bf16)
