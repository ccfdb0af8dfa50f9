"""A read-only OCDBT key-value store: the database under an orbax step.

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
from typing import Dict, List, Optional, Tuple

from .zstd import Codec, ZstdError

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1        # offset and length of an absent root


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
