// Flash-attention backward, dQ, on the packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_dq_kernel` (singa_tpu/ops/attention.py:418,
// launched by `_packed_backward`, :610).  Same contract:
//   q, dO (B, Sq, H*D) and k, v (B, Sk, Hkv*D) in f32 or bf16 (one dtype),
//   lse and delta (B, Sq, H) f32, where delta = rowsum(dO*O) - dlse per head;
//   q head h reads kv head h / (H/Hkv).  P is recomputed tile by tile from
//   (q, k, lse) in base 2, never stored:
//     P = exp2((q*c).k - lse*log2e),  dS = P * (dO.V^T - delta),
//     dQ = scale * sum over kv tiles of dS.K,
//   accumulated in f32 and scaled and cast once at the end (:474-476);
//   c = scale*log2e is folded into q in q's dtype, as the TPU kernel
//   does (:439).
//
// What bounds it on this card: 3 products per (query, key) pair, 6*D flops,
// against reading q, k, v, dO once and writing dQ.  At the bench shape (B=8,
// S=1024, H=12, D=64, bf16, causal) that is ~19 GFLOP against ~64 MB, ~20 us
// either way at the card's peaks (operations by a hair: 0.0196 ms).
//
// Two bodies, chosen by dtype in the C entry (a route by type, not a
// fallback):
//
// bf16, the main path (flash_dq_mma_kernel): FlashAttention-2's dQ design
// on the tensor cores, from the tile code in mma_bf16.cuh that K1 and K4
// use.  The TPU kernel carries the dQ accumulator across a sequential kv
// grid axis in VMEM; CUDA blocks run in no order, so one block of 4 warps
// per (batch*q-head, 64-row q tile, output slice) runs the kv loop itself,
// stopping at the diagonal when causal; the grid starts the q tiles with
// the most kv tiles first.  Each warp owns 16 query rows.  Q and dO go to
// shared memory once by cp.async and into registers as ldmatrix A
// fragments, where they stay, Q multiplied by c = bf16(scale*log2(e))
// with `__hmul2` as it enters them (each q*c rounded to bf16, the TPU
// kernel's fold into q in q's dtype, :439; c from the host,
// attention.fold_constant); so do the rows' lse*log2e and delta.  K and
// V tiles of 64 keys are double-buffered by cp.async: the next tile's copy
// is in flight while the current one is multiplied.  Per kv tile:
// S = (Q*c).K^T and dP = dO.V^T by `mma.sync` m16n8k16 (bf16 products,
// f32 sums); P = exp2(S - lse*log2e) on the SFU, masked only on the
// diagonal tile and the ragged Sk edge; dS = P * (dP - delta); then
// dQ += dS.K with dS rounded to bf16 and reused from the accumulator
// registers as the A operand and K read by ldmatrix.trans.  That rounding
// is the TPU kernel's `ds.astype(k_ref.dtype)` (:453).  K1 and K4 fold q
// in the same way, so P agrees with K1's lse.  dQ stays in
// f32 registers; the epilogue scales it once and writes it with 16-byte
// stores staged through shared memory.  No atomics: every dQ element has
// one writer, so the result is deterministic.  Head dims: any multiple of
// 8, padded to 16, 32 or 64 columns; past 64, every block sums S and dP
// over 64-wide chunks of Q, K, dO and V (through shared memory, no double
// buffering) and grid.z splits dQ's columns into 64-wide slices.  Left for
// later: `wgmma`, TMA loads with mbarriers and warp specialisation.
//
// f32 (flash_dq_kernel): the first design, every product a scalar f32
// FMA, far above the bound.  One block per (batch*q-head, 64-row q tile,
// 64-column output slice); Q and dO stay in shared memory; each kv tile
// is scored (q.k, then dO.v) by two threads per query row, each taking
// every other key, and dS goes through shared memory once for the dS.K
// product, where each thread owns half the row's output columns.  Any D:
// the column chunk DC is the power of two from 8 to 64 at or above D
// (columns past D load as zeros); past 64, scores and dP sum over 64-wide
// chunks (Q and dO then stream through shared memory with K and V) and
// grid.z splits dQ's columns into 64-wide slices, each block recomputing
// the scores for its slice.  Ragged Sq and Sk are masked in both bodies.

#include "flash_bwd_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace flash_bwd;

template <int DC>
constexpr int smem_floats() {
  // qs, dos: (BQ, DC + 4); ks, vs: (BK, DC + 4); ps: (BQ, BK + 1)
  return (2 * BQ + 2 * BK) * (DC + 4) + BQ * (BK + 1);
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int Hkv, int D, int causal, float qscale,
                float scale) {
  constexpr int DP = DC + 4;
  constexpr int KP = BK + 1;
  constexpr int DH = DC / 2;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
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
  const int c0 = blockIdx.z * DC;  // this block's dQ columns
  const int nchunks = (D + DC - 1) / DC;
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const T* qb = q + (long)b * Sq * qstride + (long)h * D;
  const T* dob = dout + (long)b * Sq * qstride + (long)h * D;
  const T* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kvstride + (long)hk * D;

  const int qpos = q0 + row;
  float lse2 = 0.f, dl = 0.f;    // this row's lse in base 2 and delta
  if (qpos < Sq) {
    lse2 = lse[((long)b * Sq + qpos) * H + h] * LOG2E;
    dl = delta[((long)b * Sq + qpos) * H + h];
  }
  // one chunk: Q and dO stay in shared memory for the whole kv loop
  if (nchunks == 1) {
    load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, 0, D, qscale);
    load_tile<BQ, DC>(dos, dob, qstride, q0, Sq, 0, D, 1.f);
  }

  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.f;

  // causal: no row of this tile sees a key at or past q0 + BQ
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;
  const float* qrow = qs + row * DP;
  const float* dorow = dos + row * DP;
  float* prow = ps + row * KP;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // scores of keys 2*j + half in the base-2 domain, then P in place
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      __syncthreads();  // the previous readers of qs and ks are done
      if (nchunks > 1)
        load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, ci * DC, D, qscale);
      load_tile<BK, DC>(ks, kb, kvstride, k0, Sk, ci * DC, D, 1.f);
      __syncthreads();
      dot_rows<DC>(s, qrow, ks, half);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + 2 * j + half;
      const bool vis = qpos < Sq && key < Sk && (!causal || key <= qpos);
      prow[2 * j + half] = vis ? exp2f(s[j] - lse2) : 0.f;
    }
    // dP = dO.V^T for the same keys
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      __syncthreads();  // the previous readers of dos and vs are done
      if (nchunks > 1)
        load_tile<BQ, DC>(dos, dob, qstride, q0, Sq, ci * DC, D, 1.f);
      load_tile<BK, DC>(vs, vb, kvstride, k0, Sk, ci * DC, D, 1.f);
      __syncthreads();
      dot_rows<DC>(s, dorow, vs, half);
    }
    // dS = P * (dP - delta), over the entries this thread wrote
#pragma unroll
    for (int j = 0; j < 32; ++j)
      prow[2 * j + half] = prow[2 * j + half] * (s[j] - dl);
    if (nchunks > 1) {
      // K's columns of this block's dQ slice (ks holds the last chunk)
      __syncthreads();
      load_tile<BK, DC>(ks, kb, kvstride, k0, Sk, c0, D, 1.f);
      __syncthreads();
    } else {
      __syncwarp();  // the row's partner wrote the other half of prow
    }
    accumulate_rows<DC>(acc, prow, ks + half * DH);
  }

  if (qpos < Sq) {
    const int col0 = c0 + half * DH;
    T* orow = dq + ((long)b * Sq + qpos) * qstride + (long)h * D + col0;
#pragma unroll
    for (int c = 0; c < DH; ++c)
      if (col0 + c < D) orow[c] = from_f32<T>(acc[c] * scale);
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int Sq, int Sk, int H, int Hkv, int D,
                   int causal, float qscale,
                   cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_dq_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H, (D + DC - 1) / DC);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, H, Hkv, D, causal, qscale, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int Sq, int Sk, int H, int Hkv,
                         int D, int causal, float qs, cudaStream_t st) {
  if (D <= 8)
    return launch<float, 8>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 16)
    return launch<float, 16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 32)
    return launch<float, 32>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  return launch<float, DCMAX>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores

using mma_bf16::bf16;
constexpr int MMA_WARPS = 4;               // warps of 16 query rows
constexpr int MBQ = 16 * MMA_WARPS;        // query rows per block
static_assert(MMA_WARPS * 32 == THREADS, "one thread count for both bodies");

template <int DC>
constexpr int mma_smem_bytes() {
  // qs, dos (MBQ rows each); ks, vs (two buffers of BK rows each), pitch
  // DC + 8
  return (2 * MBQ + 4 * BK) * mma_bf16::pitch<DC>() * (int)sizeof(bf16);
}

// CHUNKED (D > 64): S and dP sum over DC-wide chunks of Q, K, dO and V,
// loaded one after the other; grid.z picks the DC output columns.
template <int DC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int D, int causal,
                    float qscale, float scale) {
  namespace mb = mma_bf16;
  constexpr int P = mb::pitch<DC>();
  constexpr int NT = BK / 8;       // n-tiles of the 16 x BK strip of S
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + MBQ * P;
  bf16* ks = dos + MBQ * P;        // two buffers of BK rows
  bf16* vs = ks + 2 * BK * P;      // two buffers of BK rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBQ;  // most kv tiles first
  const int c0 = blockIdx.z * DC;  // this block's dQ columns
  const int row0 = warp * 16;      // this warp's rows of the q tile
  const int qrow = q0 + row0 + (lane >> 2);  // query of accumulator row 0
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const bf16* qb = q + (long)b * Sq * qstride + (long)h * D;
  const bf16* dob = dout + (long)b * Sq * qstride + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const bf16* vb = v + (long)b * Sk * kvstride + (long)hk * D;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(qscale);  // exact

  // causal: no row of this tile sees a key at or past q0 + MBQ
  const int kv_end = causal ? min(Sk, q0 + MBQ) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;

  // lse in base 2 and delta of this thread's two rows (zeros past Sq: Q
  // and dO load as zeros there, so dS is 0)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qq = qrow + 8 * r;
    const long i = ((long)b * Sq + qq) * H + h;
    lse2[r] = qq < Sq ? lse[i] * LOG2E : 0.f;
    dl[r] = qq < Sq ? delta[i] : 0.f;
  }

  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[DC / 16][4], df[DC / 16][4];

  if constexpr (!CHUNKED) {
    mb::load_tile<MBQ, DC, THREADS>(qs, qb, qstride, q0, Sq, 0, D);
    mb::load_tile<MBQ, DC, THREADS>(dos, dob, qstride, q0, Sq, 0, D);
    mb::load_tile<BK, DC, THREADS>(ks, kb, kvstride, 0, Sk, 0, D);
    mb::load_tile<BK, DC, THREADS>(vs, vb, kvstride, 0, Sk, 0, D);
    mb::cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const bf16* kt;
    if constexpr (!CHUNKED) {
      const int buf = it & 1;
      if (it + 1 < ntiles) {       // the next tile's copy, in flight
        mb::load_tile<BK, DC, THREADS>(ks + (buf ^ 1) * BK * P, kb,
                                       kvstride, k0 + BK, Sk, 0, D);
        mb::load_tile<BK, DC, THREADS>(vs + (buf ^ 1) * BK * P, vb,
                                       kvstride, k0 + BK, Sk, 0, D);
      }
      mb::cp_commit();
      mb::cp_wait<1>();            // this tile (and Q, dO) has landed
      __syncthreads();
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(qf[kk], qs, row0, kk * 16);
          mb::mul_bf16x2(qf[kk], c2);  // q*c in bf16, once
          mb::load_a<DC>(df[kk], dos, row0, kk * 16);
        }
      }
      kt = ks + buf * BK * P;
      mb::gemm_nt<DC, NT>(s, qf, kt);
      mb::gemm_nt<DC, NT>(dp, df, vs + buf * BK * P);
    } else {
      const int nchunks = (D + DC - 1) / DC;
      for (int ci = 0; ci < nchunks; ++ci) {
        __syncthreads();           // the previous readers of the tiles
        mb::load_tile<MBQ, DC, THREADS>(qs, qb, qstride, q0, Sq, ci * DC, D);
        mb::load_tile<MBQ, DC, THREADS>(dos, dob, qstride, q0, Sq, ci * DC,
                                        D);
        mb::load_tile<BK, DC, THREADS>(ks, kb, kvstride, k0, Sk, ci * DC, D);
        mb::load_tile<BK, DC, THREADS>(vs, vb, kvstride, k0, Sk, ci * DC, D);
        mb::cp_commit();
        mb::cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(qf[kk], qs, row0, kk * 16);
          mb::mul_bf16x2(qf[kk], c2);
          mb::load_a<DC>(df[kk], dos, row0, kk * 16);
        }
        mb::gemm_nt<DC, NT>(s, qf, ks);
        mb::gemm_nt<DC, NT>(dp, df, vs);
      }
      // K's columns of this block's dQ slice
      __syncthreads();
      mb::load_tile<BK, DC, THREADS>(ks, kb, kvstride, k0, Sk, c0, D);
      mb::cp_commit();
      mb::cp_wait<0>();
      __syncthreads();
      kt = ks;
    }

    // P and dS; accumulator s[j][e] is query qrow + 8 * (e >> 1) against
    // key k0 + 8j + 2t + (e & 1)
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = mb::exp2_approx(s[j][e] - lse2[r]);
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > qrow + 8 * r)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    }
    mb::gemm_pn<DC, BK / 16>(acc, dp, kt);  // dS rounded to bf16 here
    if constexpr (!CHUNKED)
      __syncthreads();             // done with this buffer before its refill
  }

  // this warp's rows of qs are read by this warp alone: stage dQ there
  mb::store_rows<DC>(acc, scale, scale, qs, row0, dq + (long)b * Sq * qstride
                     + (long)h * D, qstride, q0 + row0, Sq, c0, D);
}

template <int DC, bool CHUNKED>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int Sq, int Sk, int H, int Hkv,
                       int D, int causal, float qscale,
                   cudaStream_t stream) {
  const int bytes = mma_smem_bytes<DC>();
  auto kern = flash_dq_mma_kernel<DC, CHUNKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + MBQ - 1) / MBQ,
                  CHUNKED ? (D + DC - 1) / DC : 1);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, H, Hkv, D, causal, qscale, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int Sq, int Sk,
                          int H, int Hkv, int D, int causal, float qs,
                          cudaStream_t st) {
  // 16-byte copies: D a multiple of 8, every bf16 operand on 16 bytes
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dq)) & 15) == 0;
  if (D % 8 != 0 || !aligned || (Sq + MBQ - 1) / MBQ > 65535)
    return cudaErrorInvalidValue;
  if (D <= 16)
    return launch_mma<16, false>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 32)
    return launch_mma<32, false>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 64)
    return launch_mma<64, false>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  return launch_mma<64, true>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, qs, st);
}

}  // namespace

extern "C" {

// qscale: scale*log2(e) in q's dtype, rounded on the host
// (attention.fold_constant); dtype: 0 = float32 (scalar body),
// 1 = bfloat16 (tensor-core body).  Returns a cudaError_t.
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int Sq,
             int Sk, int H, int Hkv, int D, int causal, double qscale,
             int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                             Hkv, D, causal, (float)qscale, st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                              Hkv, D, causal, (float)qscale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
