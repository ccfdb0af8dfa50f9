// Flash-attention backward, dK and dV, on the packed layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_packed_dkv_kernel` (singa_tpu/ops/attention.py:479,
// launched by `_packed_backward`, :627).  Same contract:
//   q, dO (B, Sq, H*D) and k, v (B, Sk, Hkv*D) in f32 or bf16 (one dtype),
//   lse and delta (B, Sq, H) f32, where delta = rowsum(dO*O) - dlse per head.
//   P is recomputed tile by tile from (q, k, lse) in base 2, never stored:
//     P = exp2(s - lse*log2e),  dS = P * (dO.V^T - delta),
//     dV = sum over q tiles of P^T.dO,  dK = scale * sum of dS^T.Q,
//   summed over the H/Hkv q heads that share each kv head (GQA, :497-499),
//   accumulated in f32 and cast once at the end.
//
// What bounds it on this card: 4 products per (query, key) pair and q head,
// 8*D flops, against reading q, k, v, dO once and writing dK and dV.  At the
// bench shape (B=8, S=1024, H=12, D=64, bf16, causal) that is ~26 GFLOP
// against ~76 MB: ~26 us by operations at the card's peaks (~23 us by
// bytes).  This first version does every product as a scalar f32 FMA, as K1
// does, so it is bound by FMA and shared-memory instruction throughput, far
// above that floor.
//
// Design: the TPU kernel carries dK and dV across a sequential q grid axis
// in VMEM; CUDA blocks run in no order, so one block per (batch*kv-head,
// 64-row k tile, 64-column output slice) loops over the q heads of its group
// and, for each, over the q tiles from the diagonal on (causal) or all of
// them, with both accumulators in f32 registers.  K (pre-scaled by
// scale*log2(e) for the scores) and V stay in shared memory; each q tile's
// Q, dO, lse and delta stream through it.  Two threads share a key row: each
// scores every other query of the tile (k.q, then v.dO), P and then dS go
// through shared memory once for the P^T.dO and dS^T.Q products, where each
// thread owns half the row's output columns.  No atomics: every dK and dV
// element has one writer, so the result is deterministic.
//
// Head dims: any D, as flash_dq.cu: the chunk DC is the power of two from 8
// to 64 at or above D; past 64 the scores sum over 64-wide chunks and grid.z
// splits the outputs' columns.  Ragged Sq and Sk are masked; a key no query
// sees (causal, k >= Sq) gets zero gradients.

#include "flash_bwd_common.cuh"

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
                   int D, int causal, cudaStream_t stream) {
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
      scale * LOG2E, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int Sq, int Sk, int H,
                     int Hkv, int D, int causal, cudaStream_t st) {
  if (D <= 8)
    return launch<T, 8>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, st);
  if (D <= 16)
    return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, st);
  if (D <= 32)
    return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, st);
  return launch<T, DCMAX>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype,
              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                                H, Hkv, D, causal, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B,
                                        Sq, Sk, H, Hkv, D, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
