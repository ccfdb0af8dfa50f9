// Flash-attention forward on the packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_fwd_kernel` (singa_tpu/ops/attention.py:335,
// launched by `_packed_forward`, :548-584).  Same contract:
//   q (B, Sq, H*D), k/v (B, Sk, Hkv*D) in f32 or bf16, packed rows read with
//   strides H*D and Hkv*D (no transposes); q head h reads kv head h / (H/Hkv)
//   (native GQA); online softmax in base 2; causal tiles past the diagonal
//   are never visited;
//   out: O (B, Sq, H*D) in the input dtype, lse (B, Sq, H) natural log, f32.
//
// What bounds it on this card: at the bench shape (B=8, S=1024, H=12, D=64,
// bf16, causal) the work is ~12.9 GFLOP of products against ~50.7 MB of
// traffic: 13 us by operations at 989 TFLOP/s, 15 us by bytes at 3.35 TB/s,
// so the kernel is bound by bytes (0.0151 ms).
//
// Two bodies, chosen by dtype in the C entry (a route by type, not a
// fallback):
//
// bf16, the main path (flash_fwd_mma_kernel): FlashAttention-2's design on
// the tensor cores, from the tile code in mma_bf16.cuh.  One block of 4
// warps per (batch*q-head, 64-row q tile, output slice); each warp owns 16
// query rows.  The grid runs the q tiles with the most kv tiles first
// (causal load balance; 8 warps with 128-row q tiles measured slower at
// the bench shape).  Q goes to shared memory once by cp.async and
// into registers by ldmatrix, where it stays for the whole kv loop.  K and
// V tiles of 64 keys are double-buffered by cp.async: the next tile's copy
// is in flight while the current one is multiplied.  As its fragments
// enter registers, Q is multiplied by c = bf16(scale*log2(e)) with
// `__hmul2`, each q*c rounded to bf16: the TPU kernel's fold of the scale
// into q in q's dtype (:370).  c comes from the host (fold_constant in
// singa_tpu_torch/ops/attention.py), already rounded.  S = (Q*c).K^T then
// runs on `mma.sync` m16n8k16 (exact products, f32 sums) and is already
// in the base-2 domain.  The online softmax runs in f32 registers in base 2 (2^x on the SFU's
// ex2.approx), row max and row sum across the quad of threads that share
// an accumulator row; the mask is applied only on tiles that cross the
// diagonal or the ragged Sk edge (the TPU kernel's MASK_SPLIT, :389-403).  P is rounded to bf16 and reused from
// the accumulator registers as the A operand of P.V (V read by
// ldmatrix.trans), as the TPU kernel's `p.astype(v_ref.dtype)` (:384); the
// row sum l takes the unrounded f32 P.  O stays in f32 registers; the
// epilogue divides by l and writes O with 16-byte stores staged through
// shared memory, and lse.  Head dims: any multiple of 8, padded to a tile
// width of 16, 32, 64 or 128 with zero columns; past 128 the scores are
// summed over 128-wide chunks of Q and K (both through shared memory, no
// double buffering) and grid.z splits the output columns into 128-wide
// slices.  Left for later: `wgmma` from shared memory, TMA loads with
// mbarriers and warp specialisation (FlashAttention-3's design).
//
// f32 (flash_fwd_kernel): the first design, scalar f32 FMAs, two orders of
// magnitude above the bound.  One block per (batch*q-head, 64-row q tile,
// slice of DC output columns); Q, K and V tiles sit in shared memory as f32
// (rows padded by 4 floats); two threads share a query row, each scoring
// every other key; P goes through shared memory once per tile for the PV
// product.  Any D: the tile width DC is the power of two from 8 to 128 at
// or above D; past 128, D is covered in 128-wide chunks as above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 2 * BQ; // two threads per query row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
                   int causal, float qscale, cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H, (D + DC - 1) / DC);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, H, Hkv, D, causal, qscale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Sk, int H,
                         int Hkv, int D, int causal, float qs,
                         cudaStream_t stream) {
  if (D <= 8) return launch<float, 8>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 16) return launch<float, 16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 32) return launch<float, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 64) return launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  return launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores

using mma_bf16::bf16;
constexpr int MMA_WARPS = 4;               // warps of 16 query rows
constexpr int MBQ = 16 * MMA_WARPS;        // query rows per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;

template <int DC>
constexpr int mma_smem_bytes() {
  // qs (MBQ rows), ks and vs (two buffers of BK rows each), pitch DC + 8
  return (MBQ + 4 * BK) * mma_bf16::pitch<DC>() * (int)sizeof(bf16);
}

// CHUNKED (D > 128): the scores sum over DC-wide chunks of Q and K, loaded
// one after the other; grid.z picks the DC output columns of this block.
template <int DC, bool CHUNKED>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     int D, int causal, float qscale) {
  namespace mb = mma_bf16;
  constexpr int P = mb::pitch<DC>();
  constexpr int NT = BK / 8;       // n-tiles of the 16 x BK score strip
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + MBQ * P;          // two buffers of BK rows
  bf16* vs = ks + 2 * BK * P;      // two buffers of BK rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBQ;  // most kv tiles first
  const int c0 = blockIdx.z * DC;  // this block's output columns
  const int row0 = warp * 16;      // this warp's rows of the q tile
  const int qrow = q0 + row0 + (lane >> 2);  // query of accumulator row 0
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const bf16* qb = q + (long)b * Sq * qstride + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const bf16* vb = v + (long)b * Sk * kvstride + (long)hk * D;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(qscale);  // exact

  // causal: no row of this tile sees a key at or past q0 + MBQ
  const int kv_end = causal ? min(Sk, q0 + MBQ) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[DC / 16][4];

  if constexpr (!CHUNKED) {
    mb::load_tile<MBQ, DC, MMA_THREADS>(qs, qb, qstride, q0, Sq, 0, D);
    mb::load_tile<BK, DC, MMA_THREADS>(ks, kb, kvstride, 0, Sk, 0, D);
    mb::load_tile<BK, DC, MMA_THREADS>(vs, vb, kvstride, 0, Sk, 0, D);
    mb::cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* vt;
    if constexpr (!CHUNKED) {
      const int buf = it & 1;
      if (it + 1 < ntiles) {       // the next tile's copy, in flight
        mb::load_tile<BK, DC, MMA_THREADS>(ks + (buf ^ 1) * BK * P, kb,
                                           kvstride, k0 + BK, Sk, 0, D);
        mb::load_tile<BK, DC, MMA_THREADS>(vs + (buf ^ 1) * BK * P, vb,
                                           kvstride, k0 + BK, Sk, 0, D);
      }
      mb::cp_commit();
      mb::cp_wait<1>();            // this tile (and Q) has landed
      __syncthreads();
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(qf[kk], qs, row0, kk * 16);
          mb::mul_bf16x2(qf[kk], c2);  // q*c in bf16, once
        }
      }
      mb::gemm_nt<DC, NT>(s, qf, ks + buf * BK * P);
      vt = vs + buf * BK * P;
    } else {
      const int nchunks = (D + DC - 1) / DC;
      for (int ci = 0; ci < nchunks; ++ci) {
        __syncthreads();           // the previous readers of qs, ks, vs
        mb::load_tile<MBQ, DC, MMA_THREADS>(qs, qb, qstride, q0, Sq, ci * DC,
                                           D);
        mb::load_tile<BK, DC, MMA_THREADS>(ks, kb, kvstride, k0, Sk,
                                           ci * DC, D);
        if (ci == nchunks - 1)
          mb::load_tile<BK, DC, MMA_THREADS>(vs, vb, kvstride, k0, Sk, c0,
                                             D);
        mb::cp_commit();
        mb::cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(qf[kk], qs, row0, kk * 16);
          mb::mul_bf16x2(qf[kk], c2);
        }
        mb::gemm_nt<DC, NT>(s, qf, ks);
      }
      vt = vs;
    }

    // online softmax in base 2; row r of this thread is query qrow + 8r,
    // its keys k0 + 8j + 2t + (e & 1) for accumulator s[j][e]
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > qrow + 8 * (e >> 1)))
            s[j][e] = NEG_INF;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = mb::exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];  // the quad's partial sums, reduced at the end
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = !masked || x > 0.5f * NEG_INF
                            ? mb::exp2_approx(x - mx[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    mb::gemm_pn<DC, BK / 16>(acc, s, vt);
    if constexpr (!CHUNKED)
      __syncthreads();             // done with this buffer before its refill
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
  // this warp's rows of qs are read by this warp alone: stage O there
  mb::store_rows<DC>(acc, inv[0], inv[1], qs, row0,
                     o + (long)b * Sq * qstride + (long)h * D, qstride,
                     q0 + row0, Sq, c0, D);
  if (t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow + 8 * r < Sq)
        lse[((long)b * Sq + qrow + 8 * r) * H + h] =
            m[r] * (1.f / LOG2E) + logf(l[r]);
  }
}

template <int DC, bool CHUNKED>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Sq, int Sk, int H, int Hkv,
                       int D, int causal, float qscale, cudaStream_t stream) {
  const int bytes = mma_smem_bytes<DC>();
  auto kern = flash_fwd_mma_kernel<DC, CHUNKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + MBQ - 1) / MBQ, CHUNKED ? (D + DC - 1) / DC : 1);
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, D, causal, qscale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int Sq, int Sk, int H,
                          int Hkv, int D, int causal, float qs,
                          cudaStream_t stream) {
  // 16-byte copies: D a multiple of 8, every operand on 16 bytes
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (D % 8 != 0 || !aligned || (Sq + MBQ - 1) / MBQ > 65535)
    return cudaErrorInvalidValue;
  if (D <= 16) return launch_mma<16, false>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 32) return launch_mma<32, false>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 64) return launch_mma<64, false>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  if (D <= 128) return launch_mma<128, false>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
  return launch_mma<128, true>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qs, stream);
}

}  // namespace

extern "C" {

// qscale: scale*log2(e) in q's dtype, rounded on the host
// (attention.fold_constant); dtype: 0 = float32 (scalar body),
// 1 = bfloat16 (tensor-core body).  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
              int causal, double qscale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal,
                             (float)qscale, st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal,
                              (float)qscale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
