// Shared pieces of the flash-attention backward kernels (flash_dq.cu, K3;
// flash_dkv.cu, K4): tile sizes, dtype conversion, the shared-memory tile
// loader and the scalar tile dot product.  Each kernel source is built into
// its own library; the build hashes this header with each source.
#pragma once

#include <cuda_runtime.h>

namespace flash_bwd {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 128;    // two threads per row of the block's tile
constexpr int DCMAX = 64;       // widest column chunk; D > 64 in 64-wide chunks
constexpr float LOG2E = 1.4426950408889634f;

// the scalar bodies take f32 alone (bf16 goes to the tensor-core bodies)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// rows [row0, row0 + ROWS) x columns [col0, col0 + DC) of a packed operand
// (row stride `stride` elements) into a (ROWS, DC + 4) f32 tile, times
// `scale`; zeros past S rows or D columns, so padded columns add nothing
template <int ROWS, int DC, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long stride, int row0, int S,
                                          int col0, int D, float scale) {
  for (int i = threadIdx.x; i < ROWS * DC; i += THREADS) {
    const int r = i / DC, c = i % DC;
    const int s = row0 + r, col = col0 + c;
    dst[r * (DC + 4) + c] =
        s < S && col < D ? to_f32(src[(long)s * stride + col]) * scale : 0.f;
  }
}

// acc[j] += a_row . b[2j + half] over the DC columns of a chunk: the row
// operand `arow` against every other row of the 64-row tile `b`
template <int DC>
__device__ __forceinline__ void dot_rows(float (&acc)[32], const float* arow,
                                         const float* b, int half) {
  constexpr int DP = DC + 4;
#pragma unroll 2
  for (int d = 0; d < DC; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(arow + d);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(b + (2 * j + half) * DP + d);
      acc[j] += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
  }
}

// acc[c] += sum_j w[j] * m[j][c] over the 64 rows of tile `m`, for the
// DC/2 columns starting at `mcol` (this thread's half of the chunk)
template <int DC>
__device__ __forceinline__ void accumulate_rows(float (&acc)[DC / 2],
                                                const float* w,
                                                const float* mcol) {
  constexpr int DP = DC + 4;
#pragma unroll 4
  for (int j = 0; j < 64; ++j) {
    const float p = w[j];
    const float* mr = mcol + j * DP;
#pragma unroll
    for (int c = 0; c < DC / 2; c += 4) {
      const float4 m = *reinterpret_cast<const float4*>(mr + c);
      acc[c] += p * m.x;
      acc[c + 1] += p * m.y;
      acc[c + 2] += p * m.z;
      acc[c + 3] += p * m.w;
    }
  }
}

}  // namespace flash_bwd
