"""OCDBT key-value stores, read and written: the database under an orbax
step.

Orbax writes a step's arrays through tensorstore into an OCDBT database
(`<step>/default/`): `manifest.ocdbt` at its root, B+tree nodes, version
tree nodes and values in data files under `d/`, and, where the step was
written by several processes, their own databases under
`ocdbt.process_<n>/`, which the root's nodes refer into.  This module
reads such a database with the standard library, numpy and a `Codec`
(`utils/zstd.py`: the plain decoder, or the native one for a restore on
the card), and nothing else.

Every manifest and node is an encoded file: a 4-byte big-endian magic
(0x0cdb3a2a manifest, 0x0cdb20de B+tree node, 0x0cdb1234 version tree
node), a little-endian u64 length equal to its size, a format version
and a compression varint (0 none, 1 zstd), the body, then the CRC32C of
everything before it.  Inside, arrays are stored by column: a data file
table (each path prefix-coded against the one before, a base path and a
path relative to it), then each field of every entry in turn.

`OcdbtWriter(root)` writes such a database the smallest way: one
version, inline in the manifest; one B+tree leaf node holding every key,
with each value of at most `MAX_INLINE_VALUE_BYTES` inline and the rest
in one data file under `d/`, the node after them; nodes and manifest
uncompressed (compression 0).  The config is orbax's (1024 bytes
inline, 100 MB a decoded node, the single-file manifest).

`OcdbtStore(root, codec)` takes the manifest's config and its latest
version (inline, or the newest leaf of its version tree), walks the
B+tree once when it opens (keys are stored by prefix: an interior entry
holds its subtree's first key and the length of the prefix all its
keys share, which the child's keys are stored without) and offers
`list(prefix)` and `read(key)`.  Bytes that are
torn (a CRC mismatch, a short or missing file, a frame that does not
decode) raise `OrbaxTornStepError`, which a restore walks back past; a
format version, compression, manifest kind or node kind this reader
does not know raises `OrbaxUnreadableError` naming it.  `FileStore(root)`
reads keys from a plain directory, for a step written with
`use_ocdbt: false`.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from .zstd import Codec, ZstdError, crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1        # offset and length of an absent root
# orbax's config for the databases it writes
# (`tensorstore_utils.add_ocdbt_write_options`)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class OrbaxUnreadableError(RuntimeError):
    """An orbax step this reader does not understand: its metadata
    describes a tree it does not handle, or its bytes use a format
    version, compression, codec or dtype it does not know.  Never walked
    past: the step is there and may be the newest."""


class OrbaxTornStepError(OSError):
    """An orbax step whose bytes are torn: a metadata file that does not
    parse, a checksum that does not match, a short or missing file, a
    frame that does not decode.  A restore walks back past it, as past
    a torn npz snapshot."""


class _Bytes:
    """A cursor over a decoded body."""

    __slots__ = ("b", "i", "what")

    def __init__(self, b: bytes, what: str):
        self.b, self.i, self.what = b, 0, what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise OrbaxUnreadableError(f"{self.what}: body ends inside a "
                                       f"field (a layout this reader does "
                                       f"not know)")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxUnreadableError(f"{self.what}: varint too long")

    def take(self, n: int) -> bytes:
        self._need(n)
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def le(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def column(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def decode_envelope(data: bytes, magic: int, what: str, codec: Codec) -> bytes:
    """The body of an encoded OCDBT file (manifest or node), its CRC32C
    and length checked."""
    if len(data) < 18:
        raise OrbaxTornStepError(f"{what}: {len(data)} bytes, shorter than "
                                 f"an OCDBT envelope")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OrbaxTornStepError(f"{what}: magic {got:#010x}, expected "
                                 f"{magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OrbaxTornStepError(f"{what}: {len(data)} bytes where its "
                                 f"header says {length}")
    if codec.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OrbaxTornStepError(f"{what}: CRC32C mismatch")
    head = _Bytes(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OrbaxUnreadableError(f"{what}: OCDBT format version {version}")
    compression = head.varint()
    body = data[12 + head.i:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OrbaxUnreadableError(f"{what}: OCDBT compression id "
                                   f"{compression}")
    try:
        return bytes(codec.decompress(body))
    except ZstdError as e:
        raise OrbaxTornStepError(f"{what}: zstd frame does not decode "
                                 f"({e})") from e


# a data file: (base path, path relative to it), both under the root
DataFile = Tuple[str, str]
# a value: its bytes inline, or (data file, offset, length)
Ref = Tuple[DataFile, int, int]


def _data_files(r: _Bytes, base: str) -> List[DataFile]:
    """A data file table; paths in it are relative to `base`, the base
    path of the file that holds it."""
    n = r.varint()
    prefix = [0] + r.column(max(n - 1, 0))
    suffix = r.column(n)
    base_len = r.column(n)
    out: List[DataFile] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            raise OrbaxUnreadableError(f"{r.what}: corrupt data file table")
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        text = path.decode()
        out.append((base + text[:base_len[i]], text[base_len[i]:]))
    return out


def _refs(r: _Bytes, n: int, files: List[DataFile],
          lengths: Optional[List[int]] = None) -> List[Ref]:
    ids = r.column(n)
    offsets = r.column(n)
    if lengths is None:
        lengths = r.column(n)
    if any(i >= len(files) for i in ids):
        raise OrbaxUnreadableError(f"{r.what}: data file id past its table")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _generations(r: _Bytes, files: List[DataFile]):
    """[(generation, root height, root ref)] of a column of B+tree
    generation references (the manifest's inline versions, a version
    tree leaf)."""
    n = r.varint()
    gens = r.column(n)
    heights = [r.u8() for _ in range(n)]
    roots = _refs(r, n, files)
    for _ in range(3 * n):      # num_keys, num_tree_bytes, indirect bytes
        r.varint()
    for _ in range(n):          # commit times
        r.le(8)
    return list(zip(gens, heights, roots))


def _version_nodes(r: _Bytes, files: List[DataFile], heights: bool):
    """[(generation, ref, height or None)] of a column of version tree
    node references (the manifest's carry heights; a node's do not)."""
    n = r.varint()
    gens = r.column(n)
    refs = _refs(r, n, files)
    r.column(n)                 # num_generations
    for _ in range(n):          # commit times
        r.le(8)
    hs = [r.u8() for _ in range(n)] if heights else [None] * n
    return list(zip(gens, refs, hs))


class OcdbtStore:
    """The latest version of the OCDBT database at `root`, read-only."""

    def __init__(self, root: str, codec: Codec):
        self.root = root
        self.codec = codec
        # (path, offset, length) of every encoded file read: the
        # manifest, then each node
        self.encoded: List[Tuple[str, int, int]] = []
        path = os.path.join(root, "manifest.ocdbt")
        man = self._file(path, "manifest")
        self.encoded.append((path, 0, len(man)))
        r = _Bytes(decode_envelope(man, MANIFEST_MAGIC,
                                   f"{root}/manifest.ocdbt", codec),
                   f"{root}/manifest.ocdbt")
        r.take(16)                                  # uuid
        kind = r.varint()
        if kind != 0:
            raise OrbaxUnreadableError(f"{root}: OCDBT manifest kind {kind} "
                                       f"(numbered manifests)")
        self.max_inline_value_bytes = r.varint()
        r.varint()                                  # max_decoded_node_bytes
        r.u8()                                      # version tree arity log2
        compression = r.varint()
        if compression == 1:
            r.le(4)                                 # zstd level
        elif compression != 0:
            raise OrbaxUnreadableError(f"{root}: OCDBT config compression "
                                       f"{compression}")
        files = _data_files(r, "")
        versions = _generations(r, files)
        nodes = _version_nodes(r, files, heights=True)
        self.generation, height, root_ref = self._latest(versions, nodes)
        # every key and where its value is, read once: the nodes of a
        # step are few, and the store is then read-only
        self._entries: Dict[str, object] = {}
        if root_ref[2] != _MISSING:     # an empty tree has no root node
            self._walk(root_ref, height, b"", self._entries)

    # -- files ---------------------------------------------------------------
    def _file(self, path: str, what: str, offset: int = 0,
              length: Optional[int] = None) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except OSError as e:
            raise OrbaxTornStepError(f"{path}: {what} does not read "
                                     f"({type(e).__name__}: {e})") from e
        if length is not None and len(data) != length:
            raise OrbaxTornStepError(f"{path}: {what} is short: {len(data)} "
                                     f"of {length} bytes at {offset}")
        return data

    def _ref_bytes(self, ref: Ref, what: str) -> bytes:
        (base, rel), offset, length = ref
        return self._file(os.path.join(self.root, base, rel), what, offset,
                          length)

    def _node(self, ref: Ref, magic: int, what: str) -> _Bytes:
        (base, rel), offset, length = ref
        where = f"{self.root}/{base}{rel}@{offset}"
        self.encoded.append((os.path.join(self.root, base, rel), offset,
                             length))
        return _Bytes(decode_envelope(self._ref_bytes(ref, what), magic,
                                      f"{what} {where}", self.codec),
                      f"{what} {where}")

    # -- versions ------------------------------------------------------------
    def _latest(self, versions, nodes):
        """(generation, root height, root ref) of the newest version:
        the manifest's newest inline one, else the newest leaf entry of
        its version tree."""
        if versions:
            return max(versions, key=lambda v: v[0])
        if not nodes:
            raise OrbaxUnreadableError(f"{self.root}: OCDBT manifest holds "
                                       f"no version")
        _, ref, height = max(nodes, key=lambda v: v[0])
        while True:
            r = self._node(ref, VERSION_MAGIC, "version tree node")
            r.u8()                                  # arity log2
            h = r.u8()
            if h != height:
                raise OrbaxUnreadableError(f"{r.what}: height {h}, its "
                                           f"parent says {height}")
            files = _data_files(r, ref[0][0])
            if h == 0:
                return max(_generations(r, files), key=lambda v: v[0])
            _, ref, _ = max(_version_nodes(r, files, heights=False),
                            key=lambda v: v[0])
            height = h - 1

    # -- the B+tree ----------------------------------------------------------
    def _walk(self, ref: Ref, height: int, prefix: bytes,
              out: Dict[str, object]) -> None:
        r = self._node(ref, BTREE_MAGIC, "B+tree node")
        h = r.u8()
        if h != height:
            raise OrbaxUnreadableError(f"{r.what}: height {h}, its parent "
                                       f"says {height}")
        files = _data_files(r, ref[0][0])
        n = r.varint()
        pre = [0] + r.column(max(n - 1, 0))
        suf = r.column(n)
        common = r.column(n) if h > 0 else None
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            if pre[i] > len(prev):
                raise OrbaxUnreadableError(f"{r.what}: corrupt key prefix")
            prev = prev[:pre[i]] + r.take(suf[i])
            keys.append(prev)
        if h > 0:
            children = _refs(r, n, files)
            for _ in range(3 * n):      # subtree statistics
                r.varint()
            for key, c, child in zip(keys, common, children):
                self._walk(child, h - 1, prefix + key[:c], out)
            return
        lengths = r.column(n)
        kinds = r.column(n)
        if any(k > 1 for k in kinds):
            raise OrbaxUnreadableError(f"{r.what}: value kind "
                                       f"{max(kinds)}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        refs = _refs(r, len(indirect), files,
                     [lengths[i] for i in indirect])
        for i, ref_i in zip(indirect, refs):
            out[(prefix + keys[i]).decode()] = ref_i
        for i in range(n):
            if kinds[i] == 0:
                out[(prefix + keys[i]).decode()] = r.take(lengths[i])

    def _all(self) -> Dict[str, object]:
        return self._entries

    def list(self, prefix: str = "") -> List[str]:
        """The keys under `prefix`, sorted."""
        return sorted(k for k in self._all() if k.startswith(prefix))

    def read(self, key: str) -> Optional[bytes]:
        """The value at `key`, or None where there is none."""
        v = self._all().get(key)
        if v is None or isinstance(v, bytes):
            return v
        return self._ref_bytes(v, f"value {key!r}")


class FileStore:
    """`OcdbtStore.read` over a plain directory (a step written with
    `use_ocdbt: false`)."""

    def __init__(self, root: str):
        self.root = root

    def read(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.root, *key.split("/"))
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise OrbaxTornStepError(f"{path} does not read "
                                     f"({type(e).__name__}: {e})") from e


# -- writing -----------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _column(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def encode_envelope(body: bytes, magic: int) -> bytes:
    """An encoded OCDBT file holding `body`: its magic, its length,
    format version 0, compression 0 (none), the body and the CRC32C of
    everything before it."""
    size = 4 + 8 + 2 + len(body) + 4
    data = (magic.to_bytes(4, "big") + size.to_bytes(8, "little")
            + _varint(0) + _varint(0) + body)
    return data + crc32c(data).to_bytes(4, "little")


def _prefixed(items: Sequence[bytes]) -> Tuple[bytes, bytes, bytes]:
    """(prefix lengths of all but the first, suffix lengths, suffixes) of
    sorted byte strings, each stored against the one before it."""
    pre, suf, tails = [], [], []
    prev = b""
    for i, item in enumerate(items):
        n = 0
        if i:
            top = min(len(prev), len(item))
            while n < top and prev[n] == item[n]:
                n += 1
            pre.append(n)
        suf.append(len(item) - n)
        tails.append(item[n:])
        prev = item
    return _column(pre), _column(suf), b"".join(tails)


def _file_table(paths: Sequence[str]) -> bytes:
    """A data file table of `paths`, each relative to the base path of
    the file holding the table (base path lengths 0)."""
    pre, suf, tails = _prefixed([p.encode() for p in paths])
    return _varint(len(paths)) + pre + suf + _column([0] * len(paths)) + tails


class OcdbtWriter:
    """One OCDBT database written at `root` (a directory that holds none):
    `put` each key's value, then `close`, which writes the B+tree leaf
    node and `manifest.ocdbt` and syncs every file.  Values longer than
    `MAX_INLINE_VALUE_BYTES` go into one data file, `d/<32 hex digits>`,
    in the order they were put; the leaf node follows them there."""

    def __init__(self, root: str):
        self.root = root
        self.data_rel = f"d/{uuid.uuid4().hex}"
        os.makedirs(os.path.join(root, "d"))
        self._data = open(os.path.join(root, self.data_rel), "wb")
        self._offset = 0
        # key -> its bytes (inline) or (offset, length) in the data file
        self._entries: Dict[bytes, object] = {}

    def put(self, key: str, parts: Sequence) -> None:
        """The value of `key`: `parts`, buffers written one after
        another."""
        k = key.encode()
        if k in self._entries:
            raise ValueError(f"OCDBT key {key!r} put twice")
        size = sum(memoryview(p).nbytes for p in parts)
        if size <= MAX_INLINE_VALUE_BYTES:
            self._entries[k] = b"".join(bytes(p) for p in parts)
            return
        for p in parts:
            self._data.write(p)
        self._entries[k] = (self._offset, size)
        self._offset += size

    def _leaf(self) -> bytes:
        keys = sorted(self._entries)
        values = [self._entries[k] for k in keys]
        indirect = [v for v in values if isinstance(v, tuple)]
        pre, suf, tails = _prefixed(keys)
        body = (bytes([0])                          # height 0: a leaf
                + _file_table([self.data_rel] if indirect else [])
                + _varint(len(keys)) + pre + suf + tails
                + _column(len(v) if isinstance(v, bytes) else v[1]
                          for v in values)
                + _column(int(isinstance(v, tuple)) for v in values)
                + _column(0 for _ in indirect)      # data file id
                + _column(off for off, _ in indirect)
                + b"".join(v for v in values if isinstance(v, bytes)))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"{len(keys)} keys do not fit one OCDBT leaf "
                             f"node of {MAX_DECODED_NODE_BYTES} bytes")
        return body

    def close(self) -> None:
        node = encode_envelope(self._leaf(), BTREE_MAGIC)
        node_at = self._offset
        self._data.write(node)
        self._data.flush()
        os.fsync(self._data.fileno())
        self._data.close()
        indirect = sum(v[1] for v in self._entries.values()
                       if isinstance(v, tuple))
        body = (uuid.uuid4().bytes
                + _varint(0)                        # the single-file kind
                + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(0)                        # no compression
                + _file_table([self.data_rel])
                # one inline version: generation 1, its root the leaf
                + _varint(1) + _varint(1) + bytes([0])
                + _varint(0) + _varint(node_at) + _varint(len(node))
                + _varint(len(self._entries)) + _varint(len(node))
                + _varint(indirect)
                + time.time_ns().to_bytes(8, "little")
                + _varint(0))                       # no version tree nodes
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "wb") as f:
            f.write(encode_envelope(body, MANIFEST_MAGIC))
            f.flush()
            os.fsync(f.fileno())
