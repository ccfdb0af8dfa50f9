// Fused LM-head forward for Hopper (sm_90a): logits = h . W^T over vocab
// tiles, never written to device memory, reduced on the fly to three
// per-token statistics.
//
// Replaces the TPU kernel `_fwd_kernel` (singa_tpu/ops/head_loss.py:35,
// launched by `_head_stats_pallas`, :80-106).  Same contract:
//   h (N, E), W (V, E) (the tied embedding layout), same dtype, f32 or bf16;
//   labels (N,) int32  ->  lse, label logit, hit: three (N,) f32.
//   lse is the online log-sum-exp (natural base); the label logit is the
//   exact f32 logit of the tile holding the label; hit is 1 when the row's
//   argmax equals the label, with the lowest column winning ties
//   (strictly-greater update across tiles, lowest column within a tile).
//
// What bounds it on this card: at the bench shape (N=8192, E=768, V=32768)
// the products are 2*N*V*E ~ 412 GFLOP against ~63 MB of inputs, so it is
// compute bound (~0.42 ms at the bf16 tensor-core peak).  This first
// version does every product as a scalar f32 FMA (no tensor cores), so it is
// bound by FMA and shared-memory instruction throughput, far above that
// floor.
//
// Design against that bound: one block of 8 warps per 32-token tile loops
// over 128-column vocab tiles, and over E in 32-wide slices staged through
// shared memory (rows padded to 33 floats: conflict-free stores and reads).
// Each warp owns 4 tokens and each lane 4 columns (lane + 32*j), so a thread
// keeps a 4x4 register tile of logits and every shared read feeds 4 FMAs.
// The tile's max, argmax, sum-exp and label logit reduce across the warp
// with shuffles; m, the running sum, the argmax and the label logit stay in
// registers for the whole vocab loop, so the logits never leave the SM.
// A split of V across blocks (a second pass) and wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BN = 32;    // tokens per block
constexpr int BV = 128;   // vocab columns per tile
constexpr int BE = 32;    // embedding slice staged per step
constexpr int WARPS = 8;  // 4 tokens per warp
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = BN / WARPS;   // rows per warp (4)
constexpr int CPL = BV / 32;      // columns per lane (4)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ lse_out,
                float* __restrict__ ll_out, float* __restrict__ hit_out,
                int N, int E, int V) {
  __shared__ float hs[BN][BE + 1];
  __shared__ float ws[BV][BE + 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;

  float m[RPW], dsum[RPW], ll[RPW];
  int amax[RPW], lbl[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    dsum[i] = 0.f;
    ll[i] = 0.f;
    amax[i] = 0;
    const int n = n0 + warp * RPW + i;
    lbl[i] = n < N ? labels[n] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += BV) {
    float acc[RPW][CPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

    for (int e0 = 0; e0 < E; e0 += BE) {
      __syncthreads();  // the previous slice's readers are done
      for (int idx = tid; idx < BN * BE; idx += THREADS) {
        const int r = idx / BE, c = idx - (idx / BE) * BE;
        const int n = n0 + r, e = e0 + c;
        hs[r][c] = (n < N && e < E) ? to_f32(h[(long)n * E + e]) : 0.f;
      }
      for (int idx = tid; idx < BV * BE; idx += THREADS) {
        const int r = idx / BE, c = idx - (idx / BE) * BE;
        const int col = v0 + r, e = e0 + c;
        ws[r][c] = (col < V && e < E) ? to_f32(w[(long)col * E + e]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < BE; ++e) {
        float a[RPW], bcol[CPL];
#pragma unroll
        for (int i = 0; i < RPW; ++i) a[i] = hs[warp * RPW + i][e];
#pragma unroll
        for (int j = 0; j < CPL; ++j) bcol[j] = ws[lane + 32 * j][e];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[i][j] += a[i] * bcol[j];
      }
    }

    // fold this vocab tile into the running statistics of each row
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float bmax = -INFINITY;
      int bidx = 0x40000000;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = v0 + lane + 32 * j;
        if (col < V && acc[i][j] > bmax) {  // j ascending: first max wins
          bmax = acc[i][j];
          bidx = col;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bmax, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (ov > bmax || (ov == bmax && oi < bidx)) {
          bmax = ov;
          bidx = oi;
        }
      }
      const float m_new = fmaxf(m[i], bmax);
      float bsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = v0 + lane + 32 * j;
        if (col < V) bsum += expf(acc[i][j] - m_new);
        if (col == lbl[i]) ll[i] += acc[i][j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
      dsum[i] = dsum[i] * expf(m[i] - m_new) + bsum;
      if (bmax > m[i]) amax[i] = bidx;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float lli = ll[i];  // only the lane that held the label column is nonzero
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lli += __shfl_xor_sync(0xffffffffu, lli, off);
    const int n = n0 + warp * RPW + i;
    if (lane == 0 && n < N) {
      lse_out[n] = m[i] + logf(dsum[i]);
      ll_out[n] = lli;
      hit_out[n] = amax[i] == lbl[i] ? 1.f : 0.f;
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* w, const void* labels,
                   void* lse, void* ll, void* hit, int N, int E, int V,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN);
  head_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(ll), static_cast<float*>(hit), N, E, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int head_fwd(const void* h, const void* w, const void* labels, void* lse,
             void* ll, void* hit, int N, int E, int V, int dtype,
             void* stream) {
  if (N < 1 || E < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(h, w, labels, lse, ll, hit, N, E, V, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(h, w, labels, lse, ll, hit, N, E, V, st);
  return (int)cudaErrorInvalidValue;
}

const char* head_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
