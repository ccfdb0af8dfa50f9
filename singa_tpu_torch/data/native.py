"""ctypes binding for the native shard store (native/shard_store.cc).

The hot data path runs in C++ (like the reference's shard reader,
shard.cc); Python falls back to the pure implementation in
singa_tpu_torch.data.shard when the shared library hasn't been built.
Build with `make -C native`.  The port's own copy of
`singa_tpu/data/native.py`: it loads the same `native/libsinga_native.so`
of the repository.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                         "native", "libsinga_native.so")
_lib = None
_lib_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        # a built .so that cannot load (ABI/runtime mismatch, e.g. an
        # older libstdc++ than the build host's) must degrade to the
        # pure-Python codec, not crash every batch decode
        _lib_failed = True
        import sys
        print(f"warning: native shard library unusable ({e}); "
              f"falling back to the Python codec", file=sys.stderr)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.shard_open_read.restype = ctypes.c_void_p
    lib.shard_open_read.argtypes = [ctypes.c_char_p]
    lib.shard_next.restype = ctypes.c_int
    lib.shard_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p),
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(u8p),
                               ctypes.POINTER(ctypes.c_uint64)]
    lib.shard_seek_first.argtypes = [ctypes.c_void_p]
    lib.shard_count.restype = ctypes.c_long
    lib.shard_count.argtypes = [ctypes.c_void_p]
    lib.shard_close_read.argtypes = [ctypes.c_void_p]
    lib.shard_open_write.restype = ctypes.c_void_p
    lib.shard_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.shard_insert.restype = ctypes.c_int
    lib.shard_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_char_p,
                                 ctypes.c_uint64]
    lib.shard_flush.argtypes = [ctypes.c_void_p]
    lib.shard_close_write.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.record_probe.restype = ctypes.c_int
    lib.record_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        u64p, ctypes.POINTER(ctypes.c_int32)]
    lib.record_batch_decode.restype = ctypes.c_long
    lib.record_batch_decode.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), u64p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def decode_image_batch(vals):
    """Decode a list of serialized Record protos into (pixels, labels)
    via the C++ walker (native/record_codec.cc) — one memcpy per record.

    Returns (uint8 ndarray (n, *shape), int32 ndarray (n,)), or None
    when the library isn't built or the records aren't uniform uint8
    pixel images (caller falls back to the Python codec).
    """
    import numpy as np
    lib = load_library()
    if lib is None or not vals:
        return None
    shape = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    plen = ctypes.c_uint64()
    label = ctypes.c_int32()
    if lib.record_probe(vals[0], len(vals[0]), shape, ctypes.byref(ndim),
                        ctypes.byref(plen), ctypes.byref(label)) != 0:
        return None
    dims = tuple(shape[i] for i in range(ndim.value))
    if not dims or plen.value != int(np.prod(dims)):
        return None   # float-data or shapeless record: Python path
    n = len(vals)
    # per-record pointers into the bytes objects (held alive by `vals`) —
    # no concatenation copy of the batch payload
    recs = (ctypes.c_char_p * n)(*vals)
    lens = (ctypes.c_uint64 * n)(*(len(v) for v in vals))
    pixels = np.empty((n,) + dims, np.uint8)
    labels = np.empty((n,), np.int32)
    got = lib.record_batch_decode(
        recs, lens, n, shape, ndim.value,
        pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        plen.value, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if got != n:
        return None
    return pixels, labels


class NativeShardReader:
    """Iterates (key, val) tuples via the C++ reader."""

    def __init__(self, folder: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native shard library not built "
                               "(run `make -C native`)")
        self._lib = lib
        path = os.path.join(folder, "shard.dat").encode()
        self._h = lib.shard_open_read(path)
        if not self._h:
            raise IOError(f"cannot open shard at {folder!r}")

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        self._lib.shard_seek_first(self._h)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        key_p, val_p = u8p(), u8p()
        klen, vlen = ctypes.c_uint64(), ctypes.c_uint64()
        while self._lib.shard_next(self._h, ctypes.byref(key_p),
                                   ctypes.byref(klen), ctypes.byref(val_p),
                                   ctypes.byref(vlen)):
            yield (ctypes.string_at(key_p, klen.value),
                   ctypes.string_at(val_p, vlen.value))

    def count(self) -> int:
        return self._lib.shard_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.shard_close_read(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeShardWriter:
    def __init__(self, folder: str, append: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native shard library not built")
        self._lib = lib
        path = os.path.join(folder, "shard.dat").encode()
        self._h = lib.shard_open_write(path, 1 if append else 0)
        if not self._h:
            raise IOError(f"cannot open shard for write at {folder!r}")

    def insert(self, key: bytes | str, val: bytes) -> bool:
        if isinstance(key, str):
            key = key.encode()
        return bool(self._lib.shard_insert(self._h, key, len(key),
                                           val, len(val)))

    def flush(self) -> None:
        self._lib.shard_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.shard_flush(self._h)
            self._lib.shard_close_write(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
