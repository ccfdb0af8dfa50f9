// Flash-attention forward on the packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_fwd_kernel` (singa_tpu/ops/attention.py:335,
// launched by `_packed_forward`, :548-584).  Same contract:
//   q (B, Sq, H*D), k/v (B, Sk, Hkv*D) in f32 or bf16, packed rows read with
//   strides H*D and Hkv*D (no transposes); q head h reads kv head h / (H/Hkv)
//   (native GQA); online softmax in base 2 with scale*log2(e) folded into q;
//   causal blocks past the diagonal are never visited;
//   out: O (B, Sq, H*D) in the input dtype, lse (B, Sq, H) natural log, f32.
//
// What bounds it on this card: at the bench shape (B=8, S=1024, H=12, D=64,
// bf16, causal) the work is ~12.9 GFLOP of products against ~50.7 MB of
// traffic, so with tensor cores the kernel would be memory bound (~15 us at
// 3.35 TB/s).  This first version is simple and right instead: every product
// is a scalar f32 FMA (no tensor cores), so it is bound by the FMA and
// shared-memory instruction throughput, two orders of magnitude above that
// floor.
//
// Design against that bound: one block per (batch*q-head, 64-row q tile,
// slice of DC output columns); the sequential kv grid axis of the TPU kernel
// becomes a loop inside the block that stops at the diagonal when causal.
// Q, K and V tiles sit in shared memory as f32 (rows padded by 4 floats so
// float4 reads stay aligned and the two key streams of a warp fall in
// different banks); two threads share a query row, each scoring every other
// key of the tile, so each float4 read of K feeds four FMAs and the row
// max/sum need one shuffle.  m, l and the output accumulator (half a slice
// row per thread) stay in f32 registers; P goes through shared memory once
// per tile for the PV product.
//
// Head dims: any D.  The tile width DC is the power of two from 8 to 128 at
// or above D, and columns past D are loaded as zeros (they add nothing to a
// score and are never written).  Past 128, D is covered in DC = 128 chunks:
// every kv tile scores q.k chunk by chunk (Q then streams through shared
// memory with K) and grid.z splits the output columns into 128-wide slices,
// each block recomputing the scores for its slice.  wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 2 * BQ; // two threads per query row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DC>
constexpr int smem_floats() {
  // qs, ks, vs: (rows, DC + 4) each; ps: (BQ, BK + 1)
  return (BQ + 2 * BK) * (DC + 4) + BQ * (BK + 1);
}

// rows [row0, row0 + ROWS) x columns [col0, col0 + DC) of a packed operand
// into a (ROWS, DC + 4) f32 tile, times `scale`; zeros past S rows or D columns
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

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int D, int causal, float qscale) {
  constexpr int DP = DC + 4;
  constexpr int KP = BK + 1;
  constexpr int DH = DC / 2;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * DP;

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;  // this block's output columns
  const int nchunks = (D + DC - 1) / DC;
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const T* qb = q + (long)b * Sq * qstride + (long)h * D;
  const T* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kvstride + (long)hk * D;

  // one chunk: Q stays in shared memory for the whole kv loop
  if (nchunks == 1) load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, 0, D, qscale);

  const int qpos = q0 + row;
  float m = NEG_INF, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.f;

  // causal: no row of this tile sees a key at or past q0 + BQ
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;
  const float* qrow = qs + row * DP;
  float* prow = ps + row * KP;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // scores of keys 2*j + half, in the base-2 domain
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      __syncthreads();  // the previous readers of qs, ks and vs are done
      if (nchunks > 1)
        load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, ci * DC, D, qscale);
      load_tile<BK, DC>(ks, kb, kvstride, k0, Sk, ci * DC, D, 1.f);
      if (ci == nchunks - 1)
        load_tile<BK, DC>(vs, vb, kvstride, k0, Sk, c0, D, 1.f);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < DC; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (2 * j + half) * DP + d);
          s[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int key = k0 + 2 * j + half;
      const bool vis = key < Sk && (!causal || key <= qpos);
      s[j] = vis ? s[j] : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = s[j] > 0.5f * NEG_INF ? exp2f(s[j] - m_new) : 0.f;
      psum += p;
      prow[2 * j + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's partner wrote the other half of prow

    const float* vcol = vs + half * DH;
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vr = vcol + j * DP;
#pragma unroll
      for (int c = 0; c < DH; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + c);
        acc[c] += p * vv.x;
        acc[c + 1] += p * vv.y;
        acc[c + 2] += p * vv.z;
        acc[c + 3] += p * vv.w;
      }
    }
  }

  if (qpos < Sq) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int col0 = c0 + half * DH;
    T* orow = o + ((long)b * Sq + qpos) * qstride + (long)h * D + col0;
#pragma unroll
    for (int c = 0; c < DH; ++c)
      if (col0 + c < D) orow[c] = from_f32<T>(acc[c] * inv);
    if (half == 0 && blockIdx.z == 0)
      lse[((long)b * Sq + qpos) * H + h] = m * (1.f / LOG2E) + logf(l_safe);
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                   int causal, cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H, (D + DC - 1) / DC);
  const float qscale = LOG2E / sqrtf((float)D);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, H, Hkv, D, causal, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                     int causal, cudaStream_t stream) {
  if (D <= 8) return launch<T, 8>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, stream);
  if (D <= 16) return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, stream);
  return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
              int causal, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D,
                                        causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
