"""Minimal read-only LMDB environment walker.

The reference's kLMDBData layer walks a live caffe LMDB cursor
(layer.cc:237-328: mdb_env_open + mdb_cursor_get(MDB_NEXT) over Datum
values).  No liblmdb binding exists in this environment, so this module
reads the on-disk format directly: pick the live meta page (higher
txnid), then walk the main DB's B-tree in key order, following
overflow-page chains for large values (a 3KB caffe Datum overflows a
4KB page, so this path is the common case, not an edge).

Format facts (LMDB 0.9.x data format, version 1, little-endian,
64-bit writer — caffe's deployment target):
  * page header (16 bytes): pgno u64, pad u16, flags u16, lower u16,
    upper u16; for overflow pages the lower/upper union is a u32 page
    count.
  * meta page: header + { magic u32 = 0xBEEFC0DE, version u32,
    address u64, mapsize u64, dbs[2] of 48 bytes each (free DB, main
    DB), last_pg u64, txnid u64 }.
  * MDB_db (48 bytes): pad u32, flags u16, depth u16, branch_pages
    u64, leaf_pages u64, overflow_pages u64, entries u64, root u64.
  * branch/leaf pages: u16 node offsets (from page start) at +16,
    count = (lower - 16) / 2, sorted by key.
  * node: lo u16, hi u16, flags u16, ksize u16, key bytes, then for
    leaves data of size lo | hi << 16 (or, with flag F_BIGDATA, a u64
    overflow pgno); for branches the child pgno is
    lo | hi << 16 | flags << 32.

Unsupported (fail-loud): DUPSORT sub-databases (F_DUPDATA/F_SUBDATA
nodes, P_LEAF2 pages) — caffe image DBs are plain key->value.

The port's own copy of `singa_tpu/data/lmdb_reader.py`.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF
_PAGE_SIZES = (4096, 8192, 16384, 32768, 65536, 512, 1024, 2048)


class LMDBFormatError(IOError):
    pass


def _data_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


def _page_hdr(buf: bytes, off: int):
    pgno, _, flags, lower, upper = struct.unpack_from("<QHHHH", buf, off)
    return pgno, flags, lower, upper


def _parse_meta(buf: bytes, off: int):
    """(txnid, depth, root) of the main DB from the meta at page `off`;
    None if the magic/version doesn't match."""
    magic, version = struct.unpack_from("<II", buf, off + 16)
    if magic != MAGIC or version not in (1, 999):
        return None
    main_db = off + 16 + 24 + 48          # dbs[1]
    flags, depth = struct.unpack_from("<HH", buf, main_db + 4)
    entries, root = struct.unpack_from("<QQ", buf, main_db + 32)
    (txnid,) = struct.unpack_from("<Q", buf, off + 16 + 128)
    return txnid, depth, root, entries, flags


def _detect_page_size(buf: bytes) -> int:
    # ps + 152 covers every field _parse_meta unpacks (txnid at
    # off+16+128, 8 bytes) — a file truncated inside the meta page must
    # surface as LMDBFormatError, not a raw struct.error
    for ps in _PAGE_SIZES:
        if len(buf) >= ps + 152 and _parse_meta(buf, ps) is not None:
            return ps
    raise LMDBFormatError("no LMDB meta page found at any standard "
                          "page size (is this really an LMDB file?)")


def _overflow_data(buf: bytes, pgno: int, ps: int, size: int) -> bytes:
    off = pgno * ps
    _, flags, _, _ = _page_hdr(buf, off)
    if not flags & P_OVERFLOW:
        raise LMDBFormatError(
            f"page {pgno} should be an overflow page (flags {flags:#x})")
    return bytes(buf[off + 16: off + 16 + size])


def _walk(buf: bytes, pgno: int, ps: int
          ) -> Iterator[Tuple[bytes, bytes]]:
    off = pgno * ps
    _, flags, lower, upper = _page_hdr(buf, off)
    if flags & P_LEAF2:
        raise LMDBFormatError("P_LEAF2 (DUPFIXED) pages are not "
                              "supported")
    nkeys = (lower - 16) >> 1
    ptrs = struct.unpack_from(f"<{nkeys}H", buf, off + 16)
    if flags & P_LEAF:
        for p in ptrs:
            node = off + p
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", buf, node)
            if nflags & (F_SUBDATA | F_DUPDATA):
                raise LMDBFormatError("DUPSORT sub-databases are not "
                                      "supported")
            key = bytes(buf[node + 8: node + 8 + ksize])
            dsize = lo | (hi << 16)
            dstart = node + 8 + ksize
            if nflags & F_BIGDATA:
                (opgno,) = struct.unpack_from("<Q", buf, dstart)
                yield key, _overflow_data(buf, opgno, ps, dsize)
            else:
                yield key, bytes(buf[dstart: dstart + dsize])
    elif flags & P_BRANCH:
        for p in ptrs:
            node = off + p
            lo, hi, nflags, _ = struct.unpack_from("<HHHH", buf, node)
            child = lo | (hi << 16) | (nflags << 32)
            yield from _walk(buf, child, ps)
    else:
        raise LMDBFormatError(f"page {pgno}: unexpected flags "
                              f"{flags:#x} in tree walk")


def iter_lmdb(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) pairs of the main DB in key order.  The file is
    mmapped, not slurped — real caffe envs run to tens of GB and the
    walk only touches live pages."""
    import mmap

    fp = _data_path(path)
    with open(fp, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 512:
            raise LMDBFormatError(f"{fp}: too small to be an LMDB "
                                  f"environment ({size} bytes)")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            ps = _detect_page_size(buf)
            metas = [m for m in (_parse_meta(buf, 0),
                                 _parse_meta(buf, ps))
                     if m is not None]
            if not metas:
                raise LMDBFormatError(f"{fp}: no valid meta page")
            txnid, depth, root, entries, flags = max(metas)
            if flags & 0x04:     # MDB_DUPSORT on the main DB
                raise LMDBFormatError("DUPSORT main DB is not "
                                      "supported")
            if root != _INVALID_PGNO and entries:
                yield from _walk(buf, root, ps)
        finally:
            buf.close()


def lmdb_entry_count(path: str) -> int:
    """md_entries of the live meta (no tree walk)."""
    fp = _data_path(path)
    with open(fp, "rb") as f:
        buf = f.read(128 * 1024)
    ps = _detect_page_size(buf)
    metas = [m for m in (_parse_meta(buf, 0), _parse_meta(buf, ps))
             if m is not None]
    return max(metas)[3] if metas else 0
