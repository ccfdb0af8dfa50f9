"""Shard record store — binary-compatible with the reference's format.

Reference: SINGA's include/utils/shard.h:33-142,
src/utils/shard.cc.  A shard folder holds `shard.dat`: a sequence of
tuples `[size_t keylen][key bytes][size_t vallen][val bytes]` (size_t =
8-byte little-endian).  Properties preserved:

- duplicate keys are rejected on insert (shard.cc:49-52 `keys_` set)
- kAppend rescans the file and truncates a torn tail from a crashed
  writer before appending (shard.cc:175-206 PrepareForAppend)
- buffered writes flushed explicitly (shard.cc:70-74)

A shard written by the reference's `loader` binary is readable here and
vice versa.

The port's own copy of `singa_tpu/data/shard.py`, which imports no JAX.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

_SZ = struct.Struct("<Q")   # size_t on x86-64


class ShardError(IOError):
    pass


class Shard:
    KREAD, KCREATE, KAPPEND = "r", "w", "a"

    def __init__(self, folder: str, mode: str, capacity: int = 100 * 1024 * 1024):
        if not os.path.isdir(folder):
            raise ShardError(f"Cannot open shard folder {folder}")
        self.path = os.path.join(folder, "shard.dat")
        self.mode = mode
        self.capacity = capacity
        self._keys = set()
        self._buf = bytearray()
        self._closed = False
        if mode == self.KREAD:
            self._f = open(self.path, "rb")
        elif mode == self.KCREATE:
            self._f = open(self.path, "wb")
        elif mode == self.KAPPEND:
            last_ok = self._prepare_for_append()
            self._f = open(self.path, "r+b")
            self._f.truncate(last_ok)
            self._f.seek(last_ok)
        else:
            raise ShardError(f"bad mode {mode!r}")

    # -- write path --------------------------------------------------------
    def insert(self, key: bytes | str, val: bytes) -> bool:
        if self._closed:
            # writing to a dead handle would raise a bare ValueError at
            # the next capacity flush — or worse, buffer silently until
            # then; fail at the call site instead
            raise ShardError(f"insert on closed shard {self.path}")
        if isinstance(key, str):
            key = key.encode()
        if key in self._keys or len(val) == 0:
            return False
        self._keys.add(key)
        rec = _SZ.pack(len(key)) + key + _SZ.pack(len(val)) + val
        if len(self._buf) + len(rec) > self.capacity:
            self._f.write(self._buf)
            self._buf.clear()
        self._buf += rec
        return True

    def flush(self) -> None:
        self._f.write(self._buf)
        self._f.flush()
        self._buf.clear()

    # -- read path ---------------------------------------------------------
    def seek_to_first(self) -> None:
        self._f.seek(0)

    def next(self) -> Optional[Tuple[bytes, bytes]]:
        """Next (key, val) or None at EOF / torn tail."""
        hdr = self._f.read(8)
        if len(hdr) < 8:
            return None
        klen = _SZ.unpack(hdr)[0]
        key = self._f.read(klen)
        hdr = self._f.read(8)
        if len(key) < klen or len(hdr) < 8:
            return None
        vlen = _SZ.unpack(hdr)[0]
        val = self._f.read(vlen)
        if len(val) < vlen:
            return None
        return key, val

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        self.seek_to_first()
        while True:
            kv = self.next()
            if kv is None:
                return
            yield kv

    def count(self) -> int:
        """Number of complete tuples (shard.cc:124-141 Count)."""
        pos = self._f.tell()
        n = sum(1 for _ in self)
        self._f.seek(pos)
        return n

    def close(self) -> None:
        if self._closed:
            return
        try:
            if self.mode != self.KREAD:
                self.flush()
        finally:
            # mark closed BEFORE the handle close so a flush failure
            # still retires the shard (no further inserts can land in a
            # half-flushed buffer) and close() stays idempotent
            self._closed = True
            self._f.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self.close()
        except Exception:
            # the body's exception is the one the caller must see; a
            # flush failure on the way out must not mask it (it is
            # ordinarily a symptom of the same underlying I/O error)
            if exc_type is None:
                raise
        return False

    # -- crash recovery ----------------------------------------------------
    def _prepare_for_append(self) -> int:
        """Scan for the end of the last complete tuple, registering keys
        for dedup (shard.cc:175-206)."""
        if not os.path.exists(self.path):
            open(self.path, "wb").close()
            return 0
        last_ok = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                klen = _SZ.unpack(hdr)[0]
                key = f.read(klen)
                hdr2 = f.read(8)
                if len(key) < klen or len(hdr2) < 8:
                    break
                vlen = _SZ.unpack(hdr2)[0]
                val = f.read(vlen)
                if len(val) < vlen:
                    break
                self._keys.add(key)
                last_ok = f.tell()
        return last_ok
