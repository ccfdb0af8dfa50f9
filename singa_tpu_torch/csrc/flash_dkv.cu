// Flash-attention backward, dK and dV, on the packed layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_packed_dkv_kernel` (singa_tpu/ops/attention.py:479,
// launched by `_packed_backward`, :627).  Same contract:
//   q, dO (B, Sq, H*D) and k, v (B, Sk, Hkv*D) in f32 or bf16 (one dtype),
//   lse and delta (B, Sq, H) f32, where delta = rowsum(dO*O) - dlse per head.
//   P is recomputed tile by tile from (q, k, lse) in base 2, never stored:
//     P = exp2((q*c).k - lse*log2e),  dS = P * (dO.V^T - delta),
//     dV = sum over q tiles of P^T.dO,  dK = scale * sum of dS^T.Q,
//   summed over the H/Hkv q heads that share each kv head (GQA, :497-499),
//   accumulated in f32 and cast once at the end.  No atomics: every dK and
//   dV element has one writer, so the result is deterministic.
//
// What bounds it on this card: 4 products per (query, key) pair and q head,
// 8*D flops, against reading q, k, v, dO once and writing dK and dV.  At the
// bench shape (B=8, S=1024, H=12, D=64, bf16, causal) that is ~26 GFLOP
// against ~76 MB: 26 us by operations at 989 TFLOP/s (~23 us by bytes), so
// it is bound by operations (0.0261 ms).
//
// Two bodies, chosen by dtype in the C entry (a route by type, not a
// fallback):
//
// bf16, the main path (flash_dkv_mma_kernel): FlashAttention-2's dK/dV
// design on the tensor cores, from the tile code in mma_bf16.cuh.  The TPU
// kernel carries dK and dV across a sequential q grid axis in VMEM; CUDA
// blocks run in no order, so one block of 4 warps per (batch*kv-head,
// 64-key tile, output slice) loops over the q heads of its group and, for
// each, over the q tiles from the diagonal on (causal) or all of them; the
// grid starts the key tiles that see the most q tiles first.  Each warp
// owns 16 keys.  K and V are loaded once and kept in registers as ldmatrix
// A fragments.  The Q and dO tiles of 64 queries, with their lse and delta,
// are double-buffered in shared memory by cp.async: the next (head, q tile)
// step's copy is in flight while the current one is multiplied.  Per step:
// S^T = K.(Q*c)^T and dP^T = V.dO^T by `mma.sync` m16n8k16 (bf16 products,
// f32 sums), where each Q fragment is multiplied by c = bf16(scale*log2(e))
// with `__hmul2` as it is loaded, each q*c rounded to bf16: the TPU
// kernel's fold into q in q's dtype (:503), c from the host
// (attention.fold_constant); P^T = exp2(S^T - lse*log2e), masked only on the
// diagonal tile and the ragged Sq edge; dS^T = P^T * (dP^T - delta); then
// dV += P^T.dO and dK += dS^T.Q, with P^T and dS^T rounded to bf16 and
// reused from the accumulator registers as A operands and dO and Q read by
// ldmatrix.trans.  The roundings are the TPU kernel's `p.astype(do_ref.dtype)`
// (:512) and `ds.astype(q_ref.dtype)` (:521); the dK product takes the
// raw q from shared memory, as :521 does.  dK and
// dV stay in f32 registers; the epilogue scales dK once and writes both
// with 16-byte stores staged through shared memory.  Head dims: any
// multiple of 8, padded to 16, 32 or 64 columns; past 64, every block sums
// S^T and dP^T over 64-wide chunks of K, V, Q and dO (through shared memory,
// no double buffering) and grid.z splits the output columns into 64-wide
// slices.  Left for later: `wgmma`, TMA loads with mbarriers and warp
// specialisation.
//
// f32 (flash_dkv_kernel): the first design, every product a scalar f32
// FMA, far above the bound.  K (pre-scaled by scale*log2(e)) and V stay in
// shared memory; each q tile's Q, dO, lse and delta stream through it.  Two
// threads share a key row, each scoring every other query of the tile; P
// and then dS go through shared memory for the P^T.dO and dS^T.Q products.
// Any D, as flash_dq.cu: the chunk DC is the power of two from 8 to 64 at
// or above D; past 64 the scores sum over 64-wide chunks and grid.z splits
// the outputs' columns.  Ragged Sq and Sk are masked in both bodies; a key
// no query sees (causal, k >= Sq) gets zero gradients.

#include "flash_bwd_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace flash_bwd;

template <int DC>
constexpr int smem_floats() {
  // ks, vs: (BK, DC + 4); qs, dos: (BQ, DC + 4); ps: (BK, BQ + 1);
  // lse2s, dls: (BQ,)
  return (2 * BK + 2 * BQ) * (DC + 4) + BK * (BQ + 1) + 2 * BQ;
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D,
                 int causal, float kscale, float scale) {
  constexpr int DP = DC + 4;
  constexpr int QP = BQ + 1;
  constexpr int DH = DC / 2;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DP;
  float* qs = vs + BK * DP;
  float* dos = qs + BQ * DP;
  float* ps = dos + BQ * DP;
  float* lse2s = ps + BK * QP;
  float* dls = lse2s + BQ;

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int grp = H / Hkv;
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * DC;  // this block's dK and dV columns
  const int nchunks = (D + DC - 1) / DC;
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const T* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kvstride + (long)hk * D;

  // one chunk: K and V stay in shared memory for the whole loop
  if (nchunks == 1) {
    load_tile<BK, DC>(ks, kb, kvstride, k0, Sk, 0, D, kscale);
    load_tile<BK, DC>(vs, vb, kvstride, k0, Sk, 0, D, 1.f);
  }

  const int kpos = k0 + row;
  float acc_dk[DH], acc_dv[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  // causal: q tiles before the one holding query k0 see none of these keys
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq0 = causal ? k0 / BQ : 0;
  const float* krow = ks + row * DP;
  const float* vrow = vs + row * DP;
  float* prow = ps + row * QP;

  for (int g = 0; g < grp; ++g) {
    const int h = hk * grp + g;
    const T* qb = q + (long)b * Sq * qstride + (long)h * D;
    const T* dob = dout + (long)b * Sq * qstride + (long)h * D;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      // scores k.q of queries 2*j + half in the base-2 domain
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      for (int ci = 0; ci < nchunks; ++ci) {
        __syncthreads();  // the previous readers of qs, dos, ks, ps are done
        if (ci == 0 && tid < BQ) {
          const int qq = q0 + tid;
          const long i = ((long)b * Sq + qq) * H + h;
          lse2s[tid] = qq < Sq ? lse[i] * LOG2E : 0.f;
          dls[tid] = qq < Sq ? delta[i] : 0.f;
        }
        if (nchunks > 1)
          load_tile<BK, DC>(ks, kb, kvstride, k0, Sk, ci * DC, D, kscale);
        load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, ci * DC, D, 1.f);
        if (nchunks == 1)
          load_tile<BQ, DC>(dos, dob, qstride, q0, Sq, 0, D, 1.f);
        __syncthreads();
        dot_rows<DC>(s, krow, qs, half);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int qq = q0 + 2 * j + half;
        const bool vis = kpos < Sk && qq < Sq && (!causal || kpos <= qq);
        prow[2 * j + half] = vis ? exp2f(s[j] - lse2s[2 * j + half]) : 0.f;
      }
      // dP^T = v.dO for the same queries
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      if (nchunks == 1) {
        dot_rows<DC>(s, vrow, dos, half);
      } else {
        for (int ci = 0; ci < nchunks; ++ci) {
          __syncthreads();  // the previous readers of dos and vs are done
          load_tile<BK, DC>(vs, vb, kvstride, k0, Sk, ci * DC, D, 1.f);
          load_tile<BQ, DC>(dos, dob, qstride, q0, Sq, ci * DC, D, 1.f);
          __syncthreads();
          dot_rows<DC>(s, vrow, dos, half);
        }
        // Q's and dO's columns of this block's output slice
        __syncthreads();
        load_tile<BQ, DC>(qs, qb, qstride, q0, Sq, c0, D, 1.f);
        load_tile<BQ, DC>(dos, dob, qstride, q0, Sq, c0, D, 1.f);
      }
      __syncthreads();  // prow's other half and the slices are in place
      accumulate_rows<DC>(acc_dv, prow, dos + half * DH);
      __syncwarp();     // the row's partner is done reading P
      // dS = P * (dP - delta), over the entries this thread wrote
#pragma unroll
      for (int j = 0; j < 32; ++j)
        prow[2 * j + half] = prow[2 * j + half] * (s[j] - dls[2 * j + half]);
      __syncwarp();     // the row's partner wrote the other half of dS
      accumulate_rows<DC>(acc_dk, prow, qs + half * DH);
    }
  }

  if (kpos < Sk) {
    const int col0 = c0 + half * DH;
    const long off = ((long)b * Sk + kpos) * kvstride + (long)hk * D + col0;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      if (col0 + c < D) {
        dk[off + c] = from_f32<T>(acc_dk[c] * scale);
        dv[off + c] = from_f32<T>(acc_dv[c]);
      }
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
                   int D, int causal, float qscale,
                   cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_dkv_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, B * Hkv, (D + DC - 1) / DC);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, Hkv, D, causal,
      qscale, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int Hkv, int D, int causal, float qs,
                         cudaStream_t st) {
  if (D <= 8)
    return launch<float, 8>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 16)
    return launch<float, 16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 32)
    return launch<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  return launch<float, DCMAX>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores

using mma_bf16::bf16;

template <int DC>
constexpr int mma_smem_bytes() {
  // ks, vs (BK rows); qs, dos (two buffers of BQ rows each), pitch DC + 8;
  // lse and delta (two buffers of BQ floats each)
  return (2 * BK + 4 * BQ) * mma_bf16::pitch<DC>() * (int)sizeof(bf16) +
         4 * BQ * (int)sizeof(float);
}

// CHUNKED (D > 64): S^T and dP^T sum over DC-wide chunks of K, V, Q and dO,
// loaded one after the other; grid.z picks the DC output columns.
template <int DC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                     int D, int causal, float qscale, float scale) {
  namespace mb = mma_bf16;
  constexpr int P = mb::pitch<DC>();
  constexpr int NT = BQ / 8;       // n-tiles of the 16 x BQ strip of S^T
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + BK * P;
  bf16* qs = vs + BK * P;          // two buffers of BQ rows
  bf16* dos = qs + 2 * BQ * P;     // two buffers of BQ rows
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * P);  // two of BQ
  float* dls = lses + 2 * BQ;                                // two of BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int grp = H / Hkv;
  const int k0 = blockIdx.y * BK;  // causal: the first key tiles see most
  const int c0 = blockIdx.z * DC;  // this block's dK and dV columns
  const int row0 = warp * 16;      // this warp's keys in the tile
  const int krow = k0 + row0 + (lane >> 2);  // key of accumulator row 0
  const long qstride = (long)H * D;
  const long kvstride = (long)Hkv * D;
  const bf16* kb = k + (long)b * Sk * kvstride + (long)hk * D;
  const bf16* vb = v + (long)b * Sk * kvstride + (long)hk * D;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(qscale);  // exact

  // causal: q tiles before the one holding query k0 see none of these keys
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq0 = causal ? k0 / BQ : 0;
  const int nqt = max(nq - iq0, 0);
  const int nsteps = grp * nqt;    // (q head, q tile) steps

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  uint32_t kf[DC / 16][4], vf[DC / 16][4];

  // lse and delta of step n's 64 queries into buffer `buf`: threads
  // 0..BQ-1 copy lse, BQ..2*BQ-1 delta; zeros past Sq
  auto load_stats = [&](int hh, int q0, int buf) {
    const int i = threadIdx.x & (BQ - 1);
    const bool valid = q0 + i < Sq;
    const long at = valid ? ((long)b * Sq + q0 + i) * H + hh : 0;
    const bool is_lse = threadIdx.x < BQ;
    mb::cp_async4(mb::smem_addr((is_lse ? lses : dls) + buf * BQ + i),
                  (is_lse ? lse : delta) + at, valid);
  };
  auto step_head = [&](int n) { return hk * grp + n / nqt; };
  auto step_q0 = [&](int n) { return (iq0 + n % nqt) * BQ; };
  auto load_step = [&](int n, int buf) {
    const int hh = step_head(n), q0 = step_q0(n);
    const long off = (long)b * Sq * qstride + (long)hh * D;
    mb::load_tile<BQ, DC, THREADS>(qs + buf * BQ * P, q + off, qstride, q0,
                                   Sq, 0, D);
    mb::load_tile<BQ, DC, THREADS>(dos + buf * BQ * P, dout + off, qstride,
                                   q0, Sq, 0, D);
    load_stats(hh, q0, buf);
  };

  if constexpr (!CHUNKED) {
    if (nsteps > 0) {
      mb::load_tile<BK, DC, THREADS>(ks, kb, kvstride, k0, Sk, 0, D);
      mb::load_tile<BK, DC, THREADS>(vs, vb, kvstride, k0, Sk, 0, D);
      load_step(0, 0);
    }
    mb::cp_commit();
  }

  for (int n = 0; n < nsteps; ++n) {
    const int hh = step_head(n), q0 = step_q0(n);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    int buf = 0;
    if constexpr (!CHUNKED) {
      buf = n & 1;
      if (n + 1 < nsteps) load_step(n + 1, buf ^ 1);  // in flight
      mb::cp_commit();
      mb::cp_wait<1>();            // this step's tiles (and K, V) landed
      __syncthreads();
      if (n == 0) {
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(kf[kk], ks, row0, kk * 16);
          mb::load_a<DC>(vf[kk], vs, row0, kk * 16);
        }
      }
      // S^T = K.(Q*c)^T, each Q fragment times c in bf16 on its way in
      mb::gemm_nt<DC, NT, true>(s, kf, qs + buf * BQ * P, c2);
      mb::gemm_nt<DC, NT>(dp, vf, dos + buf * BQ * P);
    } else {
      const long off = (long)b * Sq * qstride + (long)hh * D;
      const int nchunks = (D + DC - 1) / DC;
      for (int ci = 0; ci < nchunks; ++ci) {
        __syncthreads();           // the previous readers of the tiles
        mb::load_tile<BK, DC, THREADS>(ks, kb, kvstride, k0, Sk, ci * DC, D);
        mb::load_tile<BK, DC, THREADS>(vs, vb, kvstride, k0, Sk, ci * DC, D);
        mb::load_tile<BQ, DC, THREADS>(qs, q + off, qstride, q0, Sq,
                                       ci * DC, D);
        mb::load_tile<BQ, DC, THREADS>(dos, dout + off, qstride, q0, Sq,
                                       ci * DC, D);
        if (ci == 0) load_stats(hh, q0, 0);
        mb::cp_commit();
        mb::cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          mb::load_a<DC>(kf[kk], ks, row0, kk * 16);
          mb::load_a<DC>(vf[kk], vs, row0, kk * 16);
        }
        mb::gemm_nt<DC, NT, true>(s, kf, qs, c2);
        mb::gemm_nt<DC, NT>(dp, vf, dos);
      }
      // Q's and dO's columns of this block's output slice
      __syncthreads();
      mb::load_tile<BQ, DC, THREADS>(qs, q + off, qstride, q0, Sq, c0, D);
      mb::load_tile<BQ, DC, THREADS>(dos, dout + off, qstride, q0, Sq, c0,
                                     D);
      mb::cp_commit();
      mb::cp_wait<0>();
      __syncthreads();
    }

    // P^T and dS^T; accumulator s[j][e] is key krow + 8 * (e >> 1) against
    // query q0 + 8j + 2t + (e & 1)
    const float* ls = lses + buf * BQ;
    const float* dl = dls + buf * BQ;
    const bool masked = (causal && q0 < k0 + BK - 1) || q0 + BQ > Sq;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float p = exp2f(s[j][e] - ls[col] * LOG2E);
        if (masked) {
          const int qq = q0 + col;
          if (qq >= Sq || (causal && qq < krow + 8 * (e >> 1))) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[col]);
      }
    }
    mb::gemm_pn<DC, BQ / 16>(dva, s, dos + buf * BQ * P);
    mb::gemm_pn<DC, BQ / 16>(dka, dp, qs + buf * BQ * P);
    __syncthreads();               // done with this buffer before its refill
  }

  // this warp's rows of ks and vs are read by this warp alone: stage there
  const long off = (long)b * Sk * kvstride + (long)hk * D;
  mb::store_rows<DC>(dka, scale, scale, ks, row0, dk + off, kvstride,
                     k0 + row0, Sk, c0, D);
  mb::store_rows<DC>(dva, 1.f, 1.f, vs, row0, dv + off, kvstride, k0 + row0,
                     Sk, c0, D);
}

template <int DC, bool CHUNKED>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Sk, int H,
                       int Hkv, int D, int causal, float qscale,
                   cudaStream_t stream) {
  const int bytes = mma_smem_bytes<DC>();
  auto kern = flash_dkv_mma_kernel<DC, CHUNKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hkv, (Sk + BK - 1) / BK,
                  CHUNKED ? (D + DC - 1) / DC : 1);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Hkv, D,
      causal, qscale, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B,
                          int Sq, int Sk, int H, int Hkv, int D, int causal, float qs,
                          cudaStream_t st) {
  // 16-byte copies: D a multiple of 8, every bf16 operand on 16 bytes
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  if (D % 8 != 0 || !aligned || (Sk + BK - 1) / BK > 65535)
    return cudaErrorInvalidValue;
  if (D <= 16)
    return launch_mma<16, false>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 32)
    return launch_mma<32, false>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  if (D <= 64)
    return launch_mma<64, false>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
  return launch_mma<64, true>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, qs, st);
}

}  // namespace

extern "C" {

// qscale: scale*log2(e) in q's dtype, rounded on the host
// (attention.fold_constant); dtype: 0 = float32 (scalar body),
// 1 = bfloat16 (tensor-core body).  Returns a cudaError_t.
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int Sq, int Sk, int H, int Hkv, int D, int causal, double qscale,
              int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                             H, Hkv, D, causal, (float)qscale, st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                              H, Hkv, D, causal, (float)qscale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
