// Shared pieces of the LRN kernels K5 (lrn_fwd.cu) and K6 (lrn_bwd.cu):
// the dtype conversions, the rounding of a product to the storage type,
// n^-beta, and the block geometry.
//
// Geometry: activations are channels-last, so P pixels of C channels are
// one contiguous (P, C) array and a tile of TP consecutive pixels is one
// contiguous run of TP*C elements.  A block owns one tile; thread t
// handles elements t, t + blockDim, ... (at most EPT of them, kept in
// registers), so neighbouring threads touch neighbouring addresses.  A
// block has 256 threads and a tile of up to 2048 elements; a wider
// channel row (C > 2048) takes one pixel per block and ceil(C / EPT)
// threads, rounded up to a warp, which caps C at MAX_C.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace lrn {

constexpr int EPT = 8;          // elements per thread
constexpr int THREADS = 256;    // threads per block for C <= THREADS * EPT
constexpr int MAX_THREADS = 768;
constexpr int MAX_C = MAX_THREADS * EPT;   // 6144, singa_tpu_torch/ops/lrn.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a*b of two T values as T arithmetic gives it: the product is exact in
// f32 for bf16 operands, then rounded once to T.
template <typename T>
__device__ __forceinline__ float mul_t(float a, float b) {
  return to_f32(from_f32<T>(__fmul_rn(a, b)));
}

// n^-beta in f32; r * sqrt(r), r = rsqrt(n), for beta = 0.75
// (singa_tpu/ops/lrn_pallas.py:55-59).
__device__ __forceinline__ float p_of_n(float n, float beta, int b075) {
  if (b075) {
    const float r = __frsqrt_rn(n);
    return __fmul_rn(r, sqrtf(r));
  }
  return powf(n, -beta);
}

// the channel-window sum of row[] around channel c, ascending, in f32
__device__ __forceinline__ float window_sum(const float* row, int c, int C,
                                            int half) {
  const int lo = max(c - half, 0), hi = min(c + half, C - 1);
  float s = 0.f;
  for (int j = lo; j <= hi; ++j) s = __fadd_rn(s, row[j]);
  return s;
}

struct Geometry {
  int threads, tp, blocks;
};

inline Geometry geometry(int P, int C) {
  Geometry g;
  g.threads = C <= THREADS * EPT ? THREADS : ((C + EPT - 1) / EPT + 31) / 32 * 32;
  g.tp = g.threads * EPT / C;
  g.blocks = (P + g.tp - 1) / g.tp;
  return g;
}

inline bool bad_args(int P, int C, int local_size) {
  return P < 1 || C < 1 || C > MAX_C || local_size < 1 || local_size % 2 != 1;
}

}  // namespace lrn
