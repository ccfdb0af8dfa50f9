// Tensor-core tile code for the bf16 bodies of the flash kernels
// (flash_fwd.cu, K1; flash_dq.cu, K3; flash_dkv.cu, K4; head_fwd.cu, K2),
// for Hopper (sm_90a).
//
// The pieces FlashAttention-2 is built from, as inline PTX:
//   - `cp.async.cg` 16-byte copies from device memory into shared memory,
//     with zero fill (src-size 0) for rows past S and columns past D, and
//     their commit / wait groups, so the next tile's copy is in flight
//     while the current one is multiplied;
//   - bf16 tiles in shared memory whose rows are padded by 8 elements
//     (16 bytes): the 8 row addresses of one `ldmatrix` phase then fall
//     in 8 different 16-byte bank groups, with no conflict;
//   - `ldmatrix.x4` (plain and `.trans`) from those tiles into the
//     operand fragments of `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`;
//   - the packing of two f32 accumulator values into one bf16x2 A-operand
//     register, so a product's result (P, dS) feeds the next product from
//     registers without a trip through shared memory.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major), 4 regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//     (g+8, 2t+8..);
//   B (16x8, k by n), 2 regs: (k = 2t..2t+1, n = g), (k = 2t+8.., n = g);
//   C (16x8 f32), 4 floats: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

// row pitch, in elements, of a shared-memory tile DC columns wide
template <int DC>
__host__ __device__ constexpr int pitch() { return DC + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from `src` to shared `dst`, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores: bf16 products, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (`ex2.approx.ftz`: relative error
// about 2^-22, results below 2^-126 flushed to zero); 5% off K1's time at
// the bench shape against exp2f
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to nearest bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// r[i] * c for each bf16 pair of a fragment, rounded to bf16 (`__hmul2`:
// the exact product, rounded once): the TPU kernels' fold of scale*log2(e)
// into q in q's dtype, `q * jnp.asarray(scale * LOG2E, q.dtype)`
template <int N>
__device__ __forceinline__ void mul_bf16x2(uint32_t (&r)[N],
                                           __nv_bfloat162 c) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&r[i]);
    x = __hmul2(x, c);
    r[i] = *reinterpret_cast<const uint32_t*>(&x);
  }
}

// The A fragment of keys (or queries) 16*kk .. 16*kk + 15 from the f32
// accumulators c[n] of n-tiles 2*kk and 2*kk + 1 (columns 8n .. 8n + 7),
// each value rounded to bf16: P or dS reused as the next product's A.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows [row0, row0 + ROWS) x columns [col0, col0 + DC) of a packed bf16
// operand (row stride `stride` elements) into a shared tile of pitch
// DC + 8, by cp.async, one 16-byte piece (8 columns) per copy; rows at or
// past S and columns at or past D are zero filled.  D is a multiple of 8,
// so a piece is either wholly inside D or wholly past it.  All THREADS
// threads of the block take part; the caller commits.
template <int ROWS, int DC, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int row0, int S,
                                          int col0, int D) {
  constexpr int PIECES = DC / 8;
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const int s = row0 + r, col = col0 + c;
    const bool valid = s < S && col < D;
    const bf16* from = valid ? src + (long)s * stride + col : src;
    cp_async16(base + (uint32_t)(r * pitch<DC>() + c) * 2, from, valid);
  }
}

// The A fragment (16 rows x 16 columns, row-major) at rows row0..row0+15,
// columns col0..col0+15 of a shared tile of pitch DC + 8.
template <int DC>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int col0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane & 15), c = col0 + (lane >> 4) * 8;
  ldsm_x4(a, smem_addr(tile + r * pitch<DC>() + c));
}

// B fragments of two n-tiles for a product against the tile's rows: the
// tile holds B transposed (n rows by k columns, as K for Q.K^T), rows
// n0..n0+15, k columns k0..k0+15.  b[0], b[1] serve n0..n0+7 and b[2],
// b[3] serve n0+8..n0+15.
template <int DC>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int r = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, smem_addr(tile + r * pitch<DC>() + c));
}

// B fragments of two n-tiles read with `.trans`: the tile holds B as it is
// (k rows by n columns, as V for P.V), k rows k0..k0+15, n columns
// n0..n0+15.  b[0], b[1] serve n0..n0+7 and b[2], b[3] serve n0+8..n0+15.
template <int DC>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int k0,
                                             int n0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldsm_x4_trans(b, smem_addr(tile + r * pitch<DC>() + c));
}

// acc[n] (NT n-tiles of 8 columns) += A rows . tile^T, where the A
// fragments a[kk] cover DC columns and `tile` holds NT*8 rows of B^T;
// with SCALE_B each B fragment is first multiplied by `bmul` in bf16
// (mul_bf16x2), in registers, leaving the tile as it is
template <int DC, int NT, bool SCALE_B = false>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4],
                                        const uint32_t (&a)[DC / 16][4],
                                        const bf16* tile,
                                        __nv_bfloat162 bmul = {}) {
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      load_b<DC>(b, tile, j * 16, kk * 16);
      if constexpr (SCALE_B) mul_bf16x2(b, bmul);
      mma(acc[2 * j], a[kk], b[0], b[1]);
      mma(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[n] (DC/8 n-tiles) += P . tile, where P is KT*16 columns of f32
// accumulators p[KT*2][4] rounded to bf16, and `tile` holds KT*16 rows of
// B as it is, DC columns wide
template <int DC, int KT>
__device__ __forceinline__ void gemm_pn(float (&acc)[DC / 8][4],
                                        const float (&p)[KT * 2][4],
                                        const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      uint32_t b[4];
      load_b_trans<DC>(b, tile, kk * 16, j * 16);
      mma(acc[2 * j], a, b[0], b[1]);
      mma(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// A warp's 16 rows of f32 accumulators acc[DC/8][4], times `mul`, rounded
// to bf16 into rows row0..row0+15 of a shared tile of pitch DC + 8; then
// the warp writes those rows out with 16-byte stores: row r to
// dst + (orow0 + r) * stride + col0, for rows below S and columns below D.
template <int DC>
__device__ __forceinline__ void store_rows(const float (&acc)[DC / 8][4],
                                           float mul0, float mul1,
                                           bf16* tile, int row0, bf16* dst,
                                           long stride, int orow0, int S,
                                           int col0, int D) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    bf16* r0 = tile + (row0 + g) * pitch<DC>() + j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(r0) =
        pack(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(r0 + 8 * pitch<DC>()) =
        pack(acc[j][2] * mul1, acc[j][3] * mul1);
  }
  __syncwarp();
  constexpr int PIECES = DC / 8;
#pragma unroll
  for (int i = lane; i < 16 * PIECES; i += 32) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    if (orow0 + r < S && col0 + c < D)
      *reinterpret_cast<uint4*>(dst + (long)(orow0 + r) * stride + col0 +
                                c) =
          *reinterpret_cast<const uint4*>(tile + (row0 + r) * pitch<DC>() +
                                          c);
  }
}

}  // namespace mma_bf16
