// Shared pieces of the LRN kernels K5 (lrn_fwd.cu) and K6 (lrn_bwd.cu):
// the dtype conversions, the rounding of a product to the storage type,
// n^-beta, and the geometry of their two routes.
//
// Activations are channels-last, so P pixels of C channels are one
// contiguous (P, C) array and a tile of TP consecutive pixels is one
// contiguous run of TP*C elements.  The C entry picks the route by shape
// and alignment, before the launch; no route falls back to another.
//
// Vector route (C % 8 == 0, every pointer on 16 bytes): thread t of a
// block owns channels c0 .. c0 + 7 of pixel t / V of each tile (V = C / 8
// threads per pixel, TP = 256 / V pixels per tile, or one pixel and V
// threads when C > 2048), so c0 is fixed for the kernel's life.  It
// moves its 8 values with one 16-byte access per operand (two in f32).
// The staged rows in shared memory are f32, C + 2*PAD wide, with PAD zero
// floats on each side (PAD = L/2 rounded up to 4, so rows and c0 stay on
// 16 bytes): the window needs no bounds check, and a thread reads its 8 +
// 2*PAD floats with 16-byte loads.  Blocks are persistent: a grid of at
// most (blocks an SM holds) x (SMs) walks the tiles, and each thread
// issues its loads of the next tile into registers before it computes the
// current one.
//
// General route (any other C or alignment): a block owns one tile of
// 2048 / C pixels; thread t handles elements t, t + blockDim, ... (at most
// EPT of them, kept in registers), so neighbouring threads touch
// neighbouring addresses.  A wider row (C > 2048) takes one pixel per
// block and ceil(C / EPT) threads, rounded up to a warp.
//
// Both routes cap C at MAX_C.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace lrn {

constexpr int EPT = 8;          // elements per thread, general route
constexpr int THREADS = 256;    // threads per block for C <= THREADS * EPT
constexpr int MAX_THREADS = 768;
constexpr int MAX_C = MAX_THREADS * EPT;   // 6144, singa_tpu_torch/ops/lrn.py
constexpr int VEC = 8;          // channels per thread, vector route

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

// f32 rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f32(from_f32<T>(x));
}

// n^-beta and n^-beta / n in f32.  For beta = 0.75: p = r * sqrt(r) with
// r = rsqrt(n), as the TPU kernel computes it
// (singa_tpu/ops/lrn_pallas.py:55-59), and p / n = (p * r) * r; rsqrt and
// sqrt on the special-function unit (`rsqrt.approx`, `sqrt.approx`, a
// few ulp of f32), which keeps K5 and K6 within chip_smoke.py phase 8's
// tolerances of their plain versions (IEEE forms) at a quarter less time
// than `__frsqrt_rn`, `sqrtf` and `__fdiv_rn` (PERF.md, section 6).  Any
// other beta: powf and an IEEE division.
struct NormPow {
  float p, q;   // n^-beta, n^-beta / n
};

__device__ __forceinline__ NormPow norm_pow_075(float n) {
  float r, sr;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(n));
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(sr) : "f"(r));
  const float p = __fmul_rn(r, sr);
  return {p, __fmul_rn(__fmul_rn(p, r), r)};
}

__device__ __forceinline__ NormPow norm_pow(float n, float beta, int b075) {
  if (b075) return norm_pow_075(n);
  const float p = powf(n, -beta);
  return {p, __fdiv_rn(p, n)};
}

// the channel-window sum of row[] around channel c, ascending, in f32
// (general route: bounds-checked, no padding)
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

// ---------------------------------------------------------------------------
// vector route

// zero floats on each side of a staged row for a half-window of `half`
__host__ __device__ constexpr int pad_of(int half) {
  return (half + 3) / 4 * 4;
}

// 8 consecutive values of T as raw registers: one 16-byte piece in bf16,
// two in f32
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 r[1]; };
template <> struct Raw8<float> { uint4 r[2]; };

template <typename T>
__device__ __forceinline__ void zero8(Raw8<T>& v) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(v.r) / 16); ++i)
    v.r[i] = make_uint4(0u, 0u, 0u, 0u);
}

// 8 values from `src` (on 16 bytes) into registers, streamed: each value
// is read once
template <typename T>
__device__ __forceinline__ void load8(Raw8<T>& v, const T* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(v.r) / 16); ++i) v.r[i] = __ldcs(s + i);
}

__device__ __forceinline__ void unpack8(float (&f)[8],
                                        const Raw8<__nv_bfloat16>& v) {
  const uint32_t w[4] = {v.r[0].x, v.r[0].y, v.r[0].z, v.r[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);           // low half first
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(float (&f)[8], const Raw8<float>& v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(v.r[i].x);
    f[4 * i + 1] = __uint_as_float(v.r[i].y);
    f[4 * i + 2] = __uint_as_float(v.r[i].z);
    f[4 * i + 3] = __uint_as_float(v.r[i].w);
  }
}

// f rounded to T, 8 values to `dst` (on 16 bytes), streamed
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                      const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void store8(float* dst, const float (&f)[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  __stcs(d, make_float4(f[0], f[1], f[2], f[3]));
  __stcs(d + 1, make_float4(f[4], f[5], f[6], f[7]));
}

// 8 f32 values to shared memory at `dst` (on 16 bytes)
__device__ __forceinline__ void stage8(float* dst, const float (&f)[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(f[0], f[1], f[2], f[3]);
  d[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// out[i] = the window sum around channel c0 + i, i < 8, from a staged row
// padded by PAD zeros (`row` points at the first pad), ascending, in f32,
// first term first as the plain version's `_window_sum` adds them.
// HALF >= 0: unrolled, the 8 + 2*PAD floats read with 16-byte loads;
// HALF < 0: the runtime half-window `half` and pad `pad`.
template <int HALF>
__device__ __forceinline__ void window8(float (&out)[8], const float* row,
                                        int c0, int half, int pad) {
  if constexpr (HALF >= 0) {
    constexpr int PAD = pad_of(HALF), W = VEC + 2 * PAD;
    float w[W];
    const float4* src = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 v = src[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float s = w[PAD - HALF + i];
#pragma unroll
      for (int j = 1; j <= 2 * HALF; ++j) s = __fadd_rn(s, w[PAD - HALF + i + j]);
      out[i] = s;
    }
  } else {
    const float* w = row + c0 + pad - half;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float s = w[i];
      for (int j = 1; j <= 2 * half; ++j) s = __fadd_rn(s, w[i + j]);
      out[i] = s;
    }
  }
}

struct VecGeometry {
  int v;        // threads per pixel, C / 8
  int tp;       // pixels per tile
  int threads;  // tp * v
  int pad;      // zero floats each side of a staged row
  int pitch;    // floats per staged row, C + 2 * pad
  int tiles;
};

inline VecGeometry vec_geometry(int P, int C, int half) {
  VecGeometry g;
  g.v = C / VEC;
  g.tp = g.v <= THREADS ? THREADS / g.v : 1;
  g.threads = g.tp * g.v;
  g.pad = pad_of(half);
  g.pitch = C + 2 * g.pad;
  g.tiles = (P + g.tp - 1) / g.tp;
  return g;
}

// the vector route takes 8-channel groups on 16 bytes
inline bool vec_ok(int C, const void* a, const void* b, const void* c) {
  return C % VEC == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// The unrolled vector bodies: C <= 2048 (256 threads a block, at least 4
// blocks an SM by __launch_bounds__), beta = 0.75, L = 3, 5, 7 or 9.
inline int unrolled_half(int C, int local_size, double beta) {
  const int half = local_size / 2;
  return C <= THREADS * EPT && beta == 0.75 && half >= 1 && half <= 4 ? half
                                                                      : -1;
}

// Launch a persistent vector-route kernel: as many blocks as the card
// holds at once, at most one per tile.
template <typename K, typename... Args>
cudaError_t launch_persistent(K kernel, int threads, size_t smem, int tiles,
                              cudaStream_t stream, Args... args) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace lrn
