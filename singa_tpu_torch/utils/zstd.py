"""Zstandard decoding (RFC 8878) and CRC32C, in plain Python.

Orbax writes a checkpoint's nodes and zarr chunks as zstd frames, and
OCDBT seals every node with a CRC32C.  This module is the plain version
of both: the CPU tests read workspaces through it, and `chip_smoke.py`
holds the native decoder (`csrc/zstd_dec.cu`, which a restore for the
card uses) against it frame by frame.  It decodes symbol by symbol,
as the RFC describes, and imports nothing but numpy, which only reads
XXH64's 64-bit lanes and holds the native decoder's buffers.

`decompress` decodes frames back to back: skippable frames, single-
segment and windowed headers, the frame content size and the content
checksum (XXH64) when its flag is set; Raw, RLE and Compressed blocks;
Raw, RLE, Huffman-compressed and Treeless literals over 1 or 4 streams
(Huffman weights FSE-compressed or direct); sequences with predefined,
RLE, FSE-compressed and repeated tables and the three repeat offsets.
A dictionary is refused by name.  A truncated or corrupt frame raises
`ZstdError`.  Given a `collections.Counter`, it counts each frame,
block, literals and table mode it takes.

`Codec(native)` is what the checkpoint reader calls: the plain functions
here, or the native ones built from `csrc/zstd_dec.cu`
(`ops/_kernels.py`), with no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, Optional

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50          # ... 0x184D2A5F
BLOCK_MAX = 1 << 17             # 128 KiB
_NATIVE_CAPACITY = 4            # csrc/zstd_dec.cu: output buffer too small
_NATIVE_MAX = 1 << 34           # the largest buffer a guess grows to


class ZstdError(ValueError):
    """A zstd frame that is truncated, corrupt or uses a feature this
    decoder does not take (a dictionary)."""


# -- sequence codes (RFC 8878 3.1.1.3.2.1) ---------------------------------

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                      12, 13, 14, 15, 16]
# default distributions (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, -1, -1, -1, -1]
# kind -> (default distribution, its accuracy log, max accuracy log,
# max symbol)
SEQ_KINDS = {"ll": (LL_DEFAULT, 6, 9, 35), "of": (OF_DEFAULT, 5, 8, 31),
             "ml": (ML_DEFAULT, 6, 9, 52)}


# -- bit readers ------------------------------------------------------------

class _BackBits:
    """A backward bitstream: read from the last byte's end mark down to
    bit 0, each read's first bit its most significant.  Bits below 0
    read as zeros, and `pos` goes negative: the stream has overflowed."""

    __slots__ = ("d", "pos", "cb", "cont")

    def __init__(self, d: bytes):
        if not d or d[-1] == 0:
            raise ZstdError("bitstream without an end mark")
        self.d = d
        self.pos = 8 * (len(d) - 1) + d[-1].bit_length() - 1
        self.cb = 1 << 62       # no bits held: the first read loads
        self.cont = 0

    def read(self, n: int) -> int:
        p = self.pos - n
        self.pos = p
        if n == 0:
            return 0
        if p >= self.cb:
            return (self.cont >> (p - self.cb)) & ((1 << n) - 1)
        if p < 0:
            hi = p + n
            if hi <= 0:
                return 0
            v = int.from_bytes(self.d[:(hi + 7) >> 3], "little")
            return (v & ((1 << hi) - 1)) << -p
        cbb = (p + n - 57) >> 3
        if cbb < 0:
            cbb = 0
        self.cb = cbb << 3
        self.cont = int.from_bytes(self.d[cbb:cbb + 8], "little")
        return (self.cont >> (p - self.cb)) & ((1 << n) - 1)


# -- FSE (RFC 8878 4.1) -----------------------------------------------------

def _read_ncount(d: bytes, pos: int, max_al: int, max_sym: int):
    """(normalized counts, accuracy log, position after) of an FSE table
    description at `d[pos:]`."""
    chunk = d[pos:pos + 512]
    if not chunk:
        raise ZstdError("FSE table description past the end of its block")
    v = int.from_bytes(chunk, "little")
    avail = 8 * len(chunk)
    al = (v & 15) + 5
    if al > max_al:
        raise ZstdError(f"FSE accuracy log {al} above {max_al}")
    bit = 4
    remaining = (1 << al) + 1
    threshold = 1 << al
    nb = al + 1
    norm: List[int] = []
    while remaining > 1:
        if len(norm) > max_sym:
            raise ZstdError("FSE table description has too many symbols")
        mx = 2 * threshold - 1 - remaining
        low = (v >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nb - 1
        else:
            count = (v >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nb
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        if count == 0:
            while True:
                rep = (v >> bit) & 3
                bit += 2
                norm.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or bit > avail or len(norm) > max_sym + 1:
        raise ZstdError("corrupt FSE table description")
    return norm, al, pos + (bit + 7) // 8


def _fse_table(norm: List[int], al: int):
    """The decoding table (symbol, bits, base per state) of normalized
    counts `norm` at accuracy log `al` (RFC 8878 4.1.1)."""
    size = 1 << al
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(norm):
        for _ in range(c):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("FSE counts do not fill the table")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] = x + 1
        n = al - (x.bit_length() - 1)
        nbits[u] = n
        base[u] = (x << n) - size
    return sym, nbits, base, al


def _rle_table(s: int):
    return [s], [0], [0], 0


_PREDEFINED = {k: _fse_table(d, al) for k, (d, al, _, _) in SEQ_KINDS.items()}


# -- Huffman literals (RFC 8878 4.2) ----------------------------------------

def _fse_weights(d: bytes) -> List[int]:
    """Huffman weights compressed with FSE: two interleaved states over a
    backward stream, until it overflows."""
    norm, al, pos = _read_ncount(d, 0, 6, 255)
    sym, nbits, base, _ = _fse_table(norm, al)
    br = _BackBits(d[pos:])
    s1 = br.read(al)
    s2 = br.read(al)
    out: List[int] = []
    while True:
        if len(out) > 254:
            raise ZstdError("too many Huffman weights")
        out.append(sym[s1])
        s1 = base[s1] + br.read(nbits[s1])
        if br.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + br.read(nbits[s2])
        if br.pos < 0:
            out.append(sym[s1])
            break
    return out


def _huffman_table(d: bytes, counts):
    """((symbol per code, bits per code, max bits), bytes used) of the
    Huffman tree description at the start of `d`."""
    if not d:
        raise ZstdError("Huffman tree description missing")
    hb = d[0]
    if hb < 128:
        if 1 + hb > len(d):
            raise ZstdError("Huffman weights past the end of the literals")
        weights = _fse_weights(d[1:1 + hb])
        used = 1 + hb
        counts["huffman.fse"] += 1
    else:
        n = hb - 127
        used = 1 + (n + 1) // 2
        if used > len(d):
            raise ZstdError("Huffman weights past the end of the literals")
        weights = [(d[1 + i // 2] >> 4) if i % 2 == 0 else (d[1 + i // 2] & 15)
                   for i in range(n)]
        counts["huffman.direct"] += 1
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    maxbits = total.bit_length()
    if maxbits > 11:
        raise ZstdError(f"Huffman code of {maxbits} bits")
    left = (1 << maxbits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not sum to a power of 2")
    weights.append(left.bit_length())
    size = 1 << maxbits
    sym = [0] * size
    nb = [0] * size
    p = 0
    for w in range(1, maxbits + 1):
        span = 1 << (w - 1)
        for s, ws in enumerate(weights):
            if ws == w:
                sym[p:p + span] = [s] * span
                nb[p:p + span] = [maxbits + 1 - w] * span
                p += span
    return (sym, nb, maxbits), used


def _huffman_stream(s: bytes, n: int, table) -> bytes:
    """`n` literals from one Huffman stream, read backward one code at a
    time: the `maxbits` bits below the read point (zeros below bit 0)
    index the table, which gives the symbol and the code's length, the
    bits consumed.  The stream is whole when the n-th code ends exactly
    at bit 0."""
    sym, nb, maxbits = table
    if not s or s[-1] == 0:
        raise ZstdError("Huffman stream without an end mark")
    br = _BackBits(s)
    read = br.read
    out = bytearray(n)
    for i in range(n):
        w = read(maxbits)
        br.pos += maxbits - nb[w]
        if br.pos < 0:
            raise ZstdError("Huffman stream not consumed exactly")
        out[i] = sym[w]
    if br.pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return bytes(out)


def _literals(b: bytes, st, counts):
    """(literals, position after the literals section) of block `b`."""
    h0 = b[0]
    ltype, sf = h0 & 3, (h0 >> 2) & 3
    if ltype < 2:
        if sf in (0, 2):
            regen, hl = h0 >> 3, 1
        elif sf == 1:
            regen, hl = (h0 >> 4) + (b[1] << 4), 2
        else:
            regen, hl = (h0 >> 4) + (b[1] << 4) + (b[2] << 12), 3
        if hl > len(b) or regen > BLOCK_MAX:
            raise ZstdError("literals header past the end of its block")
        if ltype == 0:
            counts["literals.raw"] += 1
            if hl + regen > len(b):
                raise ZstdError("raw literals past the end of their block")
            return b[hl:hl + regen], hl + regen
        counts["literals.rle"] += 1
        if hl >= len(b):
            raise ZstdError("RLE literals past the end of their block")
        return bytes([b[hl]]) * regen, hl + 1
    if sf < 2:
        hl, streams = 3, 1 if sf == 0 else 4
        h = int.from_bytes(b[:3], "little")
        regen, csize = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF
    elif sf == 2:
        hl, streams = 4, 4
        h = int.from_bytes(b[:4], "little")
        regen, csize = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF
    else:
        hl, streams = 5, 4
        h = int.from_bytes(b[:5], "little")
        regen, csize = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF
    if hl + csize > len(b) or regen > BLOCK_MAX:
        raise ZstdError("compressed literals past the end of their block")
    d = b[hl:hl + csize]
    if ltype == 2:
        counts["literals.compressed"] += 1
        st.huf, used = _huffman_table(d, counts)
        d = d[used:]
    else:
        counts["literals.treeless"] += 1
        if st.huf is None:
            raise ZstdError("treeless literals with no earlier Huffman table")
    counts[f"literals.streams.{streams}"] += 1
    if streams == 1:
        return _huffman_stream(d, regen, st.huf), hl + csize
    if len(d) < 10:
        raise ZstdError("4-stream literals shorter than their jump table")
    s1, s2, s3 = (int.from_bytes(d[i:i + 2], "little") for i in (0, 2, 4))
    s4 = len(d) - 6 - s1 - s2 - s3
    per = (regen + 3) // 4
    if s4 < 1 or regen - 3 * per < 0:
        raise ZstdError("corrupt 4-stream jump table")
    cuts = [6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, len(d)]
    ns = [per, per, per, regen - 3 * per]
    return b"".join(_huffman_stream(d[cuts[i]:cuts[i + 1]], ns[i], st.huf)
                    for i in range(4)), hl + csize


# -- sequences (RFC 8878 3.1.1.3.2) -----------------------------------------

def _seq_table(b: bytes, pos: int, mode: int, kind: str, st, counts):
    _, _, max_al, max_sym = SEQ_KINDS[kind]
    if mode == 0:
        counts["table.predefined"] += 1
        t = _PREDEFINED[kind]
    elif mode == 1:
        counts["table.rle"] += 1
        if pos >= len(b) or b[pos] > max_sym:
            raise ZstdError(f"corrupt RLE {kind} table")
        t = _rle_table(b[pos])
        pos += 1
    elif mode == 2:
        counts["table.fse"] += 1
        norm, al, pos = _read_ncount(b, pos, max_al, max_sym)
        t = _fse_table(norm, al)
    else:
        counts["table.repeat"] += 1
        t = st.tables.get(kind)
        if t is None:
            raise ZstdError(f"repeated {kind} table with no earlier table")
    st.tables[kind] = t
    return t, pos


def _sequences(b: bytes, pos: int, lits: bytes, out: bytearray, st,
               counts) -> None:
    """Execute the sequences section of block `b` at `pos` onto `out`."""
    if pos >= len(b):
        raise ZstdError("sequences section missing")
    n0 = b[pos]
    if n0 < 128:
        nseq, pos = n0, pos + 1
    elif n0 < 255:
        if pos + 2 > len(b):
            raise ZstdError("sequence count past the end of its block")
        nseq, pos = ((n0 - 128) << 8) + b[pos + 1], pos + 2
    else:
        if pos + 3 > len(b):
            raise ZstdError("sequence count past the end of its block")
        nseq, pos = b[pos + 1] + (b[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        counts["sequences.none"] += 1
        if pos != len(b):
            raise ZstdError("bytes after a block's empty sequences section")
        out += lits
        return
    if pos >= len(b):
        raise ZstdError("sequence modes past the end of their block")
    modes = b[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    ll_t, pos = _seq_table(b, pos, modes >> 6, "ll", st, counts)
    of_t, pos = _seq_table(b, pos, (modes >> 4) & 3, "of", st, counts)
    ml_t, pos = _seq_table(b, pos, (modes >> 2) & 3, "ml", st, counts)
    ll_sym, ll_nb, ll_base, ll_al = ll_t
    of_sym, of_nb, of_base, of_al = of_t
    ml_sym, ml_nb, ml_base, ml_al = ml_t
    br = _BackBits(b[pos:])
    ll_s = br.read(ll_al)
    of_s = br.read(of_al)
    ml_s = br.read(ml_al)
    rep = st.rep
    lp = 0
    floor = st.frame_start
    read = br.read
    for i in range(nseq):
        ofc, llc, mlc = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if ofc > 31:
            raise ZstdError(f"offset code {ofc}")
        ofv = (1 << ofc) + read(ofc)
        ml = ML_BASE[mlc] + read(ML_BITS[mlc])
        ll = LL_BASE[llc] + read(LL_BITS[llc])
        if ofv > 3:
            off = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
            counts["offset.new"] += 1
        else:
            k = ofv - 1 + (ll == 0)
            counts[f"offset.repeat{k}"] += 1
            if k == 0:
                off = rep[0]
            elif k == 1:
                off = rep[1]
                rep[1], rep[0] = rep[0], off
            elif k == 2:
                off = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
            else:
                off = rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        if lp + ll > len(lits):
            raise ZstdError("sequence takes more literals than there are")
        out += lits[lp:lp + ll]
        lp += ll
        at = len(out) - off
        if off <= 0 or at < floor:
            raise ZstdError(f"match offset {off} before the frame's start")
        if off >= ml:
            out += out[at:at + ml]
        else:
            out += (out[at:] * (ml // off + 1))[:ml]
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if br.pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    out += lits[lp:]


# -- frames (RFC 8878 3.1) --------------------------------------------------

class _FrameState:
    """What blocks of one frame hand on to the next: the Huffman table,
    the sequence tables, the repeat offsets, where the frame's output
    starts."""

    __slots__ = ("huf", "tables", "rep", "frame_start")

    def __init__(self, frame_start: int):
        self.huf = None
        self.tables: dict = {}
        self.rep = [1, 4, 8]
        self.frame_start = frame_start


def _header(src: bytes, pos: int):
    """(position after the frame header, frame content size or None,
    checksum flag, window size, single-segment flag) of the frame whose header is at `pos`
    (just past the magic)."""
    if pos >= len(src):
        raise ZstdError("frame header past the end of the data")
    fhd = src[pos]
    pos += 1
    if fhd & 0x08:
        raise ZstdError("reserved frame header bit set")
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    window = None
    if not single:
        if pos >= len(src):
            raise ZstdError("window descriptor past the end of the data")
        wd = src[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    if pos + did_size + fcs_size > len(src):
        raise ZstdError("frame header past the end of the data")
    did = int.from_bytes(src[pos:pos + did_size], "little")
    if did:
        raise ZstdError(f"frame needs dictionary {did}; dictionaries are "
                        f"not supported")
    pos += did_size
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(src[pos:pos + fcs_size], "little")
        fcs += 256 if fcs_size == 2 else 0
        pos += fcs_size
    if window is None:
        window = fcs
    return pos, fcs, (fhd >> 2) & 1, window, single


def _frame(src: bytes, pos: int, out: bytearray, counts) -> int:
    pos, fcs, checksum, window, single = _header(src, pos)
    counts["frame"] += 1
    counts["frame.single_segment" if single else "frame.windowed"] += 1
    start = len(out)
    st = _FrameState(start)
    block_max = min(window, BLOCK_MAX)
    while True:
        if pos + 3 > len(src):
            raise ZstdError("block header past the end of the data")
        h = int.from_bytes(src[pos:pos + 3], "little")
        pos += 3
        last, btype, size = h & 1, (h >> 1) & 3, h >> 3
        if btype == 3:
            raise ZstdError("reserved block type")
        if size > block_max:
            raise ZstdError(f"block of {size} bytes above {block_max}")
        if btype == 0:
            counts["block.raw"] += 1
            if pos + size > len(src):
                raise ZstdError("raw block past the end of the data")
            out += src[pos:pos + size]
            pos += size
        elif btype == 1:
            counts["block.rle"] += 1
            if pos >= len(src):
                raise ZstdError("RLE block past the end of the data")
            out += bytes([src[pos]]) * size
            pos += 1
        else:
            counts["block.compressed"] += 1
            if pos + size > len(src) or size == 0:
                raise ZstdError("compressed block past the end of the data")
            b = src[pos:pos + size]
            pos += size
            before = len(out)
            lits, lpos = _literals(b, st, counts)
            _sequences(b, lpos, lits, out, st, counts)
            if len(out) - before > block_max:
                raise ZstdError("block decodes to more than its maximum")
        if fcs is not None and len(out) - start > fcs:
            raise ZstdError("frame decodes past its content size")
        if last:
            break
    if fcs is not None and len(out) - start != fcs:
        raise ZstdError(f"frame decodes to {len(out) - start} bytes, its "
                        f"header says {fcs}")
    if checksum:
        counts["frame.checksum"] += 1
        if pos + 4 > len(src):
            raise ZstdError("content checksum past the end of the data")
        want = int.from_bytes(src[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(src, counts: Optional[Counter] = None) -> bytes:
    """The content of the zstd frames (and skippable frames) in `src`,
    back to back.  `counts`, where given, gains one for each mode
    taken."""
    src = bytes(src)
    counts = Counter() if counts is None else counts
    out = bytearray()
    pos = 0
    while pos < len(src):
        if pos + 4 > len(src):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            if pos + 8 > len(src):
                raise ZstdError("truncated skippable frame")
            size = int.from_bytes(src[pos + 4:pos + 8], "little")
            pos += 8 + size
            if pos > len(src):
                raise ZstdError("skippable frame past the end of the data")
            counts["frame.skippable"] += 1
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        pos = _frame(src, pos + 4, out, counts)
    return bytes(out)


def content_size(src) -> Optional[int]:
    """The decoded size of the frames in `src` from their headers, or
    None where a frame's header does not state it."""
    src = bytes(src)
    pos = total = 0
    while pos < len(src):
        if pos + 4 > len(src):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            if pos + 8 > len(src):
                raise ZstdError("truncated skippable frame")
            pos += 8 + int.from_bytes(src[pos + 4:pos + 8], "little")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        pos, fcs, checksum, _, _ = _header(src, pos + 4)
        if fcs is None:
            return None
        total += fcs
        while True:
            if pos + 3 > len(src):
                raise ZstdError("block header past the end of the data")
            h = int.from_bytes(src[pos:pos + 3], "little")
            pos += 3 + (1 if (h >> 1) & 3 == 1 else h >> 3)
            if h & 1:
                break
        pos += 4 * checksum
    if pos != len(src):
        raise ZstdError("frame past the end of the data")
    return total


# -- XXH64 (the content checksum) and CRC32C (OCDBT) ------------------------

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = np.frombuffer(data[:stripes * 32], "<u8").tolist()
        v1, v2, v3, v4 = v
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        p = stripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def _crc_table() -> List[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        out.append(c)
    return out


_CRC = _crc_table()


def crc32c(data) -> int:
    """CRC32C (Castagnoli, reflected, as OCDBT and zarr v3 seal bytes)."""
    crc = 0xFFFFFFFF
    t = _CRC
    for b in bytes(data):
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- the decoder a restore uses ---------------------------------------------

class Codec:
    """zstd and CRC32C for one restore: the plain functions above
    (`native=False`, a restore for the CPU) or the native ones built
    from `csrc/zstd_dec.cu` (a restore for the card), never one in place
    of the other.  The native decoder writes into a numpy buffer this
    wrapper allocates, sized from the frame headers or from `size` (a
    zarr chunk's byte count) or, where neither states it, guessed and
    grown fourfold while the decoder reports the buffer too small."""

    def __init__(self, native: bool):
        self.native = native

    def decompress(self, src, size: Optional[int] = None):
        """The decoded bytes (bytes, or a uint8 array from the native
        decoder) of the frames in `src`; `size`, where given, is what
        they must decode to."""
        if not self.native:
            out = decompress(src)
            if size is not None and len(out) != size:
                raise ZstdError(f"frames decode to {len(out)} bytes, "
                                f"{size} expected")
            return out
        from ..ops import _kernels
        src = np.frombuffer(src, np.uint8)
        exact = size if size is not None else content_size(src)
        cap = exact if exact is not None else max(1 << 16, 8 * src.size)
        got = ctypes.c_longlong()
        while True:
            out = np.empty(cap, np.uint8)
            try:
                _kernels.host_call("zstd_dec", "zstd_dec", src.ctypes.data,
                                   src.size, out.ctypes.data, cap,
                                   ctypes.addressof(got))
                break
            except _kernels.HostCallError as e:
                if (e.code != _NATIVE_CAPACITY or exact is not None
                        or cap >= _NATIVE_MAX):
                    raise ZstdError(str(e)) from e
                cap *= 4
        if exact is not None and got.value != exact:
            raise ZstdError(f"frames decode to {got.value} bytes, {exact} "
                            f"expected")
        return out[:got.value]

    def crc32c(self, data) -> int:
        if not self.native:
            return crc32c(data)
        from ..ops import _kernels
        data = np.frombuffer(data, np.uint8)
        crc = ctypes.c_uint32()
        _kernels.host_call("zstd_dec", "zstd_dec_crc32c", data.ctypes.data,
                           data.size, ctypes.addressof(crc))
        return crc.value
