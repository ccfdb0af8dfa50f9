// Flash-attention backward, dQ, on the packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_dq_kernel` (singa_tpu/ops/attention.py:418,
// launched by `_packed_backward`, :610).  Same contract:
//   q, dO (B, Sq, H*D) and k, v (B, Sk, Hkv*D) in f32 or bf16 (one dtype),
//   lse and delta (B, Sq, H) f32, where delta = rowsum(dO*O) - dlse per head;
//   q head h reads kv head h / (H/Hkv).  P is recomputed tile by tile from
//   (q, k, lse) in base 2 (scale*log2(e) folded into q), never stored:
//     P = exp2(s - lse*log2e),  dS = P * (dO.V^T - delta),
//     dQ = scale * sum over kv tiles of dS.K,
//   accumulated in f32 and scaled and cast once at the end (:474-476).
//
// What bounds it on this card: 3 products per (query, key) pair, 6*D flops,
// against reading q, k, v, dO once and writing dQ.  At the bench shape (B=8,
// S=1024, H=12, D=64, bf16, causal) that is ~19 GFLOP against ~64 MB, ~20 us
// either way at the card's peaks (operations by a hair).  This first version
// does every product as a scalar f32 FMA, as K1 does, so it is bound by FMA
// and shared-memory instruction throughput, far above that floor; mma/wgmma
// are later.
//
// Design: the TPU kernel carries the dQ accumulator across a sequential kv
// grid axis in VMEM; CUDA blocks run in no order, so the kv loop runs inside
// one block per (batch*q-head, 64-row q tile, 64-column output slice) and
// stops at the diagonal when causal.  Q and dO stay in shared memory; each
// kv tile is scored (q.k, then dO.v) by two threads per query row, each
// taking every other key, and dS goes through shared memory once for the
// dS.K product, where each thread owns half the row's output columns.  No
// atomics: every dQ element has one writer, so the result is deterministic.
//
// Head dims: any D.  The column chunk DC is the power of two from 8 to 64 at
// or above D (columns past D load as zeros); past 64, scores and dP sum over
// 64-wide chunks (Q and dO then stream through shared memory with K and V)
// and grid.z splits dQ's columns into 64-wide slices, each block recomputing
// the scores for its slice.  Ragged Sq and Sk are masked.

#include "flash_bwd_common.cuh"

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
                   int causal, cudaStream_t stream) {
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
      static_cast<T*>(dq), Sq, Sk, H, Hkv, D, causal, scale * LOG2E, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int Sq, int Sk, int H, int Hkv, int D,
                     int causal, cudaStream_t st) {
  if (D <= 8)
    return launch<T, 8>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, st);
  if (D <= 16)
    return launch<T, 16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, st);
  if (D <= 32)
    return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, st);
  return launch<T, DCMAX>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int Sq,
             int Sk, int H, int Hkv, int D, int causal, int dtype,
             void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || D < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                                Hkv, D, causal, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, Sq,
                                        Sk, H, Hkv, D, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
