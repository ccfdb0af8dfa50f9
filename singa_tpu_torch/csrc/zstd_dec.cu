// Native Zstandard decoder (RFC 8878) and CRC32C: host code, no kernel.
//
// Replaces no TPU kernel.  It is the card's path for reading the
// checkpoints the JAX package writes through orbax: every OCDBT node
// and zarr chunk of such a step is a zstd frame, and every node is
// sealed with a CRC32C (`utils/ocdbt.py`, `utils/zarr.py`).  The plain
// version is `utils/zstd.py`, which this file follows function for
// function; `chip_smoke.py` holds the two equal on every frame of the
// committed fixtures and zstd corpus, and `tests/test_torch_ocdbt.py`
// builds this file with g++ and holds it against both on the CPU.  It
// is a port of the decoding algorithm of the RFC, not of any library:
// no zstd header or binary is used.
//
// Bound: one pass over the compressed bytes and one over the output,
// on one host core; the Huffman literals and the FSE sequences decode
// symbol by symbol, so the rate is a few ns a symbol rather than the
// memory's.  Nothing here is shared but constant tables, so calls
// from several threads do not interfere.
//
// Entries (bound with ctypes by ops/_kernels.py, which builds this file
// with the kernels' nvcc command into build/kernels/):
//   int zstd_dec(src, n, dst, cap, written*)  frames back to back (and
//       skippable frames) into dst[0, cap); the decoded length in
//       *written.
//   int zstd_dec_crc32c(src, n, crc*)         CRC32C of src[0, n).
//   const char* zstd_dec_error_string(int)    what a nonzero return
//       means.

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

enum {
  kOk = 0,
  kTruncated,
  kCorrupt,
  kDictionary,
  kCapacity,
  kChecksum,
  kMagic,
  kReserved,
  kBlockSize,
  kContentSize,
  kNumErrors
};

const char* const kMessages[kNumErrors] = {
    "ok",
    "truncated frame",
    "corrupt frame",
    "frame needs a dictionary; dictionaries are not supported",
    "frames decode past the output buffer",
    "content checksum mismatch",
    "not a zstd frame",
    "reserved bit or type set",
    "block above its maximum size",
    "frame decodes to another size than its header says",
};

constexpr uint32_t kMagicNumber = 0xFD2FB528u;
constexpr uint32_t kSkippable = 0x184D2A50u;
constexpr int64_t kBlockMax = 1 << 17;

struct Status {
  int code = kOk;
};

inline uint64_t load_le(const uint8_t* p, int64_t n) {
  // up to 8 bytes at p, little-endian; n may be less than 8
  uint64_t v = 0;
  if (n >= 8) {
    std::memcpy(&v, p, 8);
    return v;
  }
  for (int64_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

// -- bit readers --------------------------------------------------------

// Backward bitstream: from the last byte's end mark down to bit 0, each
// read's first bit its most significant.  Bits below 0 read as zeros and
// pos goes negative (the stream has overflowed).
struct BackBits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;

  bool init(const uint8_t* data, int64_t size) {
    d = data;
    n = size;
    if (size <= 0 || data[size - 1] == 0) return false;
    pos = 8 * (size - 1) + highbit(data[size - 1]);
    return true;
  }

  inline uint32_t read(int nb) {
    pos -= nb;
    if (nb == 0) return 0;
    const uint64_t mask = (uint64_t(1) << nb) - 1;
    if (pos >= 0) {
      const int64_t i = pos >> 3;
      return uint32_t((load_le(d + i, n - i) >> (pos & 7)) & mask);
    }
    const int64_t hi = pos + nb;
    if (hi <= 0) return 0;
    const uint64_t v = load_le(d, n) & ((uint64_t(1) << hi) - 1);
    return uint32_t((v << -pos) & mask);
  }
};

// -- FSE (RFC 8878 4.1) -------------------------------------------------

struct FseCell {
  uint8_t sym;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  FseCell cell[512];
  int al = 0;
  bool valid = false;
};

// Normalized counts of an FSE table description at d[pos:], or false.
bool read_ncount(const uint8_t* d, int64_t size, int64_t& pos, int max_al,
                 int max_sym, int16_t* norm, int& nsym, int& al) {
  if (pos >= size) return false;
  const int64_t avail = 8 * (size - pos);
  int64_t bit = 0;
  auto peek = [&](int64_t b) -> uint32_t {
    const int64_t i = pos + (b >> 3);
    if (i >= size) return 0;
    return uint32_t(load_le(d + i, size - i) >> (b & 7));
  };
  al = int(peek(0) & 15) + 5;
  if (al > max_al) return false;
  bit = 4;
  int remaining = (1 << al) + 1;
  int threshold = 1 << al;
  int nb = al + 1;
  nsym = 0;
  while (remaining > 1) {
    if (nsym > max_sym) return false;
    const int mx = 2 * threshold - 1 - remaining;
    const uint32_t v = peek(bit);
    int count;
    if (int(v & (threshold - 1)) < mx) {
      count = int(v & (threshold - 1));
      bit += nb - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= mx;
      bit += nb;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[nsym++] = int16_t(count);
    if (count == 0) {
      while (true) {
        const int rep = int(peek(bit) & 3);
        bit += 2;
        if (nsym + rep > max_sym + 1) return false;
        for (int r = 0; r < rep; ++r) norm[nsym++] = 0;
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      nb -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || bit > avail || nsym > max_sym + 1) return false;
  pos += (bit + 7) >> 3;
  return true;
}

bool build_fse(const int16_t* norm, int nsym, int al, FseTable& t) {
  const int size = 1 << al;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.cell[high--].sym = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cell[p].sym = uint8_t(s);
      p = (p + step) & mask;
      while (p > high) p = (p + step) & mask;
    }
  }
  if (p != 0) return false;
  for (int u = 0; u < size; ++u) {
    const int s = t.cell[u].sym;
    const uint32_t x = next[s]++;
    const int nb = al - highbit(x);
    t.cell[u].nb = uint8_t(nb);
    t.cell[u].base = uint16_t((x << nb) - size);
  }
  t.al = al;
  t.valid = true;
  return true;
}

void rle_fse(int s, FseTable& t) {
  t.cell[0] = FseCell{uint8_t(s), 0, 0};
  t.al = 0;
  t.valid = true;
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Predefined {
  FseTable ll, of, ml;
  Predefined() {
    build_fse(kLLDefault, 36, 6, ll);
    build_fse(kOFDefault, 29, 5, of);
    build_fse(kMLDefault, 53, 6, ml);
  }
};

const Predefined& predefined() {
  static const Predefined p;   // thread-safe initialization (C++11)
  return p;
}

// -- Huffman literals (RFC 8878 4.2) ------------------------------------

struct HufTable {
  uint8_t sym[2048];
  uint8_t nb[2048];
  int maxbits = 0;
  bool valid = false;
};

// Huffman weights compressed with FSE: two interleaved states.
bool fse_weights(const uint8_t* d, int64_t size, uint8_t* w, int& nw) {
  int16_t norm[256];
  int nsym, al;
  int64_t pos = 0;
  if (!read_ncount(d, size, pos, 6, 255, norm, nsym, al)) return false;
  FseTable t;
  if (!build_fse(norm, nsym, al, t)) return false;
  BackBits br;
  if (!br.init(d + pos, size - pos)) return false;
  uint32_t s1 = br.read(al), s2 = br.read(al);
  nw = 0;
  while (true) {
    if (nw > 253) return false;
    w[nw++] = t.cell[s1].sym;
    s1 = t.cell[s1].base + br.read(t.cell[s1].nb);
    if (br.pos < 0) {
      w[nw++] = t.cell[s2].sym;
      break;
    }
    w[nw++] = t.cell[s2].sym;
    s2 = t.cell[s2].base + br.read(t.cell[s2].nb);
    if (br.pos < 0) {
      w[nw++] = t.cell[s1].sym;
      break;
    }
  }
  return true;
}

// The Huffman tree description at d; bytes used in `used`.
bool huffman_table(const uint8_t* d, int64_t size, HufTable& h,
                   int64_t& used) {
  if (size < 1) return false;
  uint8_t w[256];
  int nw = 0;
  const int hb = d[0];
  if (hb < 128) {
    if (1 + hb > size) return false;
    if (!fse_weights(d + 1, hb, w, nw)) return false;
    used = 1 + hb;
  } else {
    nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if (used > size) return false;
    for (int i = 0; i < nw; ++i)
      w[i] = (i % 2 == 0) ? (d[1 + i / 2] >> 4) : (d[1 + i / 2] & 15);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) return false;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return false;
  const int maxbits = highbit(total) + 1;
  if (maxbits > 11) return false;
  const uint32_t left = (1u << maxbits) - total;
  if (left & (left - 1)) return false;
  w[nw++] = uint8_t(highbit(left) + 1);
  int p = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    const int span = 1 << (wt - 1);
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      std::memset(h.sym + p, s, span);
      std::memset(h.nb + p, maxbits + 1 - wt, span);
      p += span;
    }
  }
  h.maxbits = maxbits;
  h.valid = true;
  return true;
}

bool huffman_stream(const uint8_t* s, int64_t size, int64_t n,
                    const HufTable& h, uint8_t* out) {
  BackBits br;
  if (!br.init(s, size)) return false;
  const int mb = h.maxbits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  int64_t i = 0;
  // four codes per load while 57 bits lie below the read point: one
  // 8-byte load holds the 4 x 11 bits they can take at most
  while (i + 4 <= n && br.pos >= 57) {
    const int64_t b = (br.pos - 57) >> 3;
    uint64_t c;
    std::memcpy(&c, s + b, 8);
    int64_t p = br.pos - 8 * b;
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = uint32_t((c >> (p - mb)) & mask);
      out[i + k] = h.sym[v];
      p -= h.nb[v];
    }
    br.pos = p + 8 * b;
    i += 4;
  }
  for (; i < n; ++i) {
    // peek mb bits below pos (zeros below bit 0), then consume the code
    const int64_t p = br.pos - mb;
    uint32_t v;
    if (p >= 0) {
      const int64_t j = p >> 3;
      v = uint32_t((load_le(s + j, size - j) >> (p & 7)) & mask);
    } else {
      const int64_t hi = br.pos;
      v = hi <= 0 ? 0
                  : uint32_t(((load_le(s, size) & ((uint64_t(1) << hi) - 1))
                              << -p) & mask);
    }
    out[i] = h.sym[v];
    br.pos -= h.nb[v];
    if (br.pos < 0) return false;
  }
  return br.pos == 0;
}

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  int64_t frame_start = 0;
};

// Literals section of block b; lits points into b (raw) or `buf`.
bool literals(const uint8_t* b, int64_t size, FrameState& st, uint8_t* buf,
              const uint8_t*& lits, int64_t& nlits, int64_t& pos) {
  if (size < 1) return false;
  const int h0 = b[0];
  const int ltype = h0 & 3, sf = (h0 >> 2) & 3;
  if (ltype < 2) {
    int64_t regen, hl;
    if (sf == 0 || sf == 2) {
      regen = h0 >> 3;
      hl = 1;
    } else if (sf == 1) {
      if (size < 2) return false;
      regen = (h0 >> 4) + (int64_t(b[1]) << 4);
      hl = 2;
    } else {
      if (size < 3) return false;
      regen = (h0 >> 4) + (int64_t(b[1]) << 4) + (int64_t(b[2]) << 12);
      hl = 3;
    }
    if (regen > kBlockMax) return false;
    if (ltype == 0) {
      if (hl + regen > size) return false;
      lits = b + hl;
      nlits = regen;
      pos = hl + regen;
    } else {
      if (hl >= size) return false;
      std::memset(buf, b[hl], regen);
      lits = buf;
      nlits = regen;
      pos = hl + 1;
    }
    return true;
  }
  int64_t hl, regen, csize;
  int streams;
  if (sf < 2) {
    if (size < 3) return false;
    const uint64_t h = load_le(b, 3);
    hl = 3;
    streams = sf == 0 ? 1 : 4;
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    if (size < 4) return false;
    const uint64_t h = load_le(b, 4);
    hl = 4;
    streams = 4;
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    if (size < 5) return false;
    const uint64_t h = load_le(b, 5);
    hl = 5;
    streams = 4;
    regen = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
  }
  if (hl + csize > size || regen > kBlockMax) return false;
  const uint8_t* d = b + hl;
  int64_t dn = csize;
  if (ltype == 2) {
    int64_t used;
    if (!huffman_table(d, dn, st.huf, used)) return false;
    d += used;
    dn -= used;
  } else if (!st.huf.valid) {
    return false;
  }
  if (streams == 1) {
    if (!huffman_stream(d, dn, regen, st.huf, buf)) return false;
  } else {
    if (dn < 10) return false;
    const int64_t s1 = load_le(d, 2), s2 = load_le(d + 2, 2),
                  s3 = load_le(d + 4, 2);
    const int64_t s4 = dn - 6 - s1 - s2 - s3;
    const int64_t per = (regen + 3) / 4;
    if (s4 < 1 || regen - 3 * per < 0) return false;
    const int64_t cut[5] = {6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, dn};
    for (int i = 0; i < 4; ++i) {
      const int64_t ni = i < 3 ? per : regen - 3 * per;
      if (!huffman_stream(d + cut[i], cut[i + 1] - cut[i], ni, st.huf,
                          buf + i * per))
        return false;
    }
  }
  lits = buf;
  nlits = regen;
  pos = hl + csize;
  return true;
}

// -- sequences (RFC 8878 3.1.1.3.2) -------------------------------------

bool seq_table(const uint8_t* b, int64_t size, int64_t& pos, int mode,
               int kind, FseTable& t) {
  static const int max_al[3] = {9, 8, 9}, max_sym[3] = {35, 31, 52};
  if (mode == 0) {
    const Predefined& p = predefined();
    t = kind == 0 ? p.ll : kind == 1 ? p.of : p.ml;
    return true;
  }
  if (mode == 1) {
    if (pos >= size || b[pos] > max_sym[kind]) return false;
    rle_fse(b[pos++], t);
    return true;
  }
  if (mode == 2) {
    int16_t norm[64];
    int nsym, al;
    if (!read_ncount(b, size, pos, max_al[kind], max_sym[kind], norm, nsym,
                     al))
      return false;
    return build_fse(norm, nsym, al, t);
  }
  return t.valid;   // repeat: the previous block's table
}

bool sequences(const uint8_t* b, int64_t size, int64_t pos,
               const uint8_t* lits, int64_t nlits, uint8_t* dst, int64_t cap,
               int64_t& op, FrameState& st, Status& status) {
  if (pos >= size) return false;
  const int n0 = b[pos];
  int64_t nseq;
  if (n0 < 128) {
    nseq = n0;
    pos += 1;
  } else if (n0 < 255) {
    if (pos + 2 > size) return false;
    nseq = (int64_t(n0 - 128) << 8) + b[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > size) return false;
    nseq = b[pos + 1] + (int64_t(b[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != size) return false;
    if (op + nlits > cap) {
      status.code = kCapacity;
      return false;
    }
    std::memcpy(dst + op, lits, nlits);
    op += nlits;
    return true;
  }
  if (pos >= size) return false;
  const int modes = b[pos++];
  if (modes & 3) return false;
  if (!seq_table(b, size, pos, modes >> 6, 0, st.ll)) return false;
  if (!seq_table(b, size, pos, (modes >> 4) & 3, 1, st.of)) return false;
  if (!seq_table(b, size, pos, (modes >> 2) & 3, 2, st.ml)) return false;
  BackBits br;
  if (!br.init(b + pos, size - pos)) return false;
  const FseCell* llc = st.ll.cell;
  const FseCell* ofc = st.of.cell;
  const FseCell* mlc = st.ml.cell;
  uint32_t ll_s = br.read(st.ll.al), of_s = br.read(st.of.al),
           ml_s = br.read(st.ml.al);
  uint32_t* rep = st.rep;
  int64_t lp = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    const int oc = ofc[of_s].sym, lc = llc[ll_s].sym, mc = mlc[ml_s].sym;
    if (oc > 31 || lc > 35 || mc > 52) return false;
    const uint64_t ofv = (uint64_t(1) << oc) + br.read(oc);
    const int64_t ml = kMLBase[mc] + br.read(kMLBits[mc]);
    const int64_t ll = kLLBase[lc] + br.read(kLLBits[lc]);
    int64_t off;
    if (ofv > 3) {
      off = int64_t(ofv - 3);
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = uint32_t(off);
    } else {
      const int k = int(ofv) - 1 + (ll == 0);
      if (k == 0) {
        off = rep[0];
      } else if (k == 1) {
        off = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(off);
      } else if (k == 2) {
        off = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(off);
      } else {
        off = int64_t(rep[0]) - 1;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(off);
      }
    }
    if (lp + ll > nlits) return false;
    if (op + ll + ml > cap) {
      status.code = kCapacity;
      return false;
    }
    std::memcpy(dst + op, lits + lp, ll);
    op += ll;
    lp += ll;
    if (off <= 0 || op - off < st.frame_start) return false;
    uint8_t* o = dst + op;
    const uint8_t* m = o - off;
    if (off >= ml) {
      std::memcpy(o, m, ml);
    } else {
      for (int64_t j = 0; j < ml; ++j) o[j] = m[j];
    }
    op += ml;
    if (i != nseq - 1) {
      ll_s = llc[ll_s].base + br.read(llc[ll_s].nb);
      ml_s = mlc[ml_s].base + br.read(mlc[ml_s].nb);
      of_s = ofc[of_s].base + br.read(ofc[of_s].nb);
    }
  }
  if (br.pos != 0) return false;
  if (op + (nlits - lp) > cap) {
    status.code = kCapacity;
    return false;
  }
  std::memcpy(dst + op, lits + lp, nlits - lp);
  op += nlits - lp;
  return true;
}

// -- XXH64 and CRC32C ---------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; i + 32 <= n; i += 32) {
      v1 = xround(v1, load_le(p + i, 8));
      v2 = xround(v2, load_le(p + i + 8, 8));
      v3 = xround(v3, load_le(p + i + 16, 8));
      v4 = xround(v4, load_le(p + i + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; i + 8 <= n; i += 8)
    h = rotl(h ^ xround(0, load_le(p + i, 8)), 27) * P1 + P4;
  if (i + 4 <= n) {
    h = rotl(h ^ (load_le(p + i, 4) * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, int64_t n) {
  static const CrcTables tables;
  const auto& t = tables.t;
  uint32_t crc = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {   // slicing by 8
    const uint64_t v = load_le(p + i, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; i < n; ++i) crc = t[0][(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// -- frames (RFC 8878 3.1) ----------------------------------------------

int frame(const uint8_t* src, int64_t n, int64_t& pos, uint8_t* dst,
          int64_t cap, int64_t& op, uint8_t* litbuf) {
  if (pos >= n) return kTruncated;
  const int fhd = src[pos++];
  if (fhd & 0x08) return kReserved;
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  int64_t window = -1;
  if (!single) {
    if (pos >= n) return kTruncated;
    const int wd = src[pos++];
    const int64_t base = int64_t(1) << (10 + (wd >> 3));
    window = base + (base >> 3) * (wd & 7);
  }
  static const int did_sizes[4] = {0, 1, 2, 4};
  const int did_size = did_sizes[fhd & 3];
  const int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2
                       : fcs_flag == 2 ? 4 : 8;
  if (pos + did_size + fcs_size > n) return kTruncated;
  if (load_le(src + pos, did_size) != 0) return kDictionary;
  pos += did_size;
  int64_t fcs = -1;
  if (fcs_size) {
    fcs = int64_t(load_le(src + pos, fcs_size)) + (fcs_size == 2 ? 256 : 0);
    pos += fcs_size;
  }
  if (window < 0) window = fcs;
  const int64_t block_max = window < kBlockMax ? window : kBlockMax;
  const int64_t start = op;
  FrameState st;
  st.frame_start = start;
  while (true) {
    if (pos + 3 > n) return kTruncated;
    const uint32_t h = uint32_t(load_le(src + pos, 3));
    pos += 3;
    const int last = h & 1, btype = (h >> 1) & 3;
    const int64_t size = h >> 3;
    if (btype == 3) return kReserved;
    if (size > block_max) return kBlockSize;
    if (btype == 0) {
      if (pos + size > n) return kTruncated;
      if (op + size > cap) return kCapacity;
      std::memcpy(dst + op, src + pos, size);
      op += size;
      pos += size;
    } else if (btype == 1) {
      if (pos >= n) return kTruncated;
      if (op + size > cap) return kCapacity;
      std::memset(dst + op, src[pos], size);
      op += size;
      pos += 1;
    } else {
      if (pos + size > n || size == 0) return kTruncated;
      const uint8_t* b = src + pos;
      pos += size;
      const uint8_t* lits;
      int64_t nlits, lpos;
      const int64_t before = op;
      if (!literals(b, size, st, litbuf, lits, nlits, lpos)) return kCorrupt;
      Status status;
      if (!sequences(b, size, lpos, lits, nlits, dst, cap, op, st, status))
        return status.code != kOk ? status.code : kCorrupt;
      if (op - before > block_max) return kBlockSize;
    }
    if (fcs >= 0 && op - start > fcs) return kContentSize;
    if (last) break;
  }
  if (fcs >= 0 && op - start != fcs) return kContentSize;
  if (fhd & 4) {
    if (pos + 4 > n) return kTruncated;
    const uint32_t want = uint32_t(load_le(src + pos, 4));
    if (uint32_t(xxh64(dst + start, op - start)) != want) return kChecksum;
    pos += 4;
  }
  return kOk;
}

}  // namespace

extern "C" int zstd_dec(const void* src_, long long n, void* dst_,
                        long long cap, void* written_) {
  const uint8_t* src = static_cast<const uint8_t*>(src_);
  uint8_t* dst = static_cast<uint8_t*>(dst_);
  int64_t pos = 0, op = 0;
  uint8_t* litbuf = new uint8_t[kBlockMax];
  int code = kOk;
  while (pos < n) {
    if (pos + 4 > n) {
      code = kTruncated;
      break;
    }
    const uint32_t magic = uint32_t(load_le(src + pos, 4));
    if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (pos + 8 > n) {
        code = kTruncated;
        break;
      }
      pos += 8 + int64_t(load_le(src + pos + 4, 4));
      if (pos > n) {
        code = kTruncated;
        break;
      }
      continue;
    }
    if (magic != kMagicNumber) {
      code = kMagic;
      break;
    }
    pos += 4;
    code = frame(src, n, pos, dst, cap, op, litbuf);
    if (code != kOk) break;
  }
  delete[] litbuf;
  *static_cast<long long*>(written_) = op;
  return code;
}

extern "C" int zstd_dec_crc32c(const void* src, long long n, void* crc) {
  *static_cast<uint32_t*>(crc) =
      crc32c(static_cast<const uint8_t*>(src), int64_t(n));
  return kOk;
}

extern "C" const char* zstd_dec_error_string(int code) {
  return (code >= 0 && code < kNumErrors) ? kMessages[code]
                                          : "unknown error";
}
