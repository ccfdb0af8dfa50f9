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
// compute bound (~0.42 ms at the bf16 tensor-core peak).
//
// Two bodies, chosen by dtype in the C entry (a route by type, not a
// fallback):
//
// bf16, the main path (head_fwd_mma_kernel + head_merge_kernel): a GEMM on
// the tensor cores whose epilogue folds each logit tile into per-row
// online statistics, from the tile code in mma_bf16.cuh.  h is the
// row-major A operand and W's rows are the "B transposed" tile, as K is
// in Q.K^T, so no operand is transposed.  One block of 8 warps per
// (128-token tile, range of the vocab); the 8 warps split the block's
// 128 x 128 logit tile into 4 row groups x 2 column halves, each warp a
// 32 x 64 tile of `mma.sync` m16n8k16 accumulators (bf16 products, f32
// sums; 64 a thread).  E goes by in 64-wide chunks of h and W, copied by
// cp.async three stages deep, so two chunks are in flight while one is
// multiplied.  At the end of each vocab tile every thread folds its own
// accumulators into running (max, sum-exp, argmax, label logit) for its
// 4 rows, with no shuffle: sum-exp in base 2 on the SFU, the argmax the
// lowest column of a strictly greater max, the label logit the exact f32
// accumulator.  The logits never leave registers.  At the end of its
// vocab range a block merges its threads' statistics (quad shuffles, then
// the two column halves through shared memory; the larger max wins, the
// lower column on equal maxima) and writes one 16-byte partial per row
// to a workspace.  blockIdx.x is the token tile, so the blocks resident
// at one time share one range of W (6 MB at the bench shape), which
// stays in the 50 MB L2: W is read from device memory about once, where
// the first design read all 48 MB of it once per 32 tokens through L2.
// The second kernel, on the same stream, merges each row's partials in V
// order with the strictly-greater rule, so the lowest column wins a tie
// across ranges too, and writes lse, label logit and hit.  No atomics:
// the result is deterministic.  Any E that is a multiple of 8 (16-byte
// copies; columns past E load as zeros), any N and V (rows past N and
// columns past V are masked).  Left for later: `wgmma`, TMA and a
// persistent schedule.
//
// f32 (head_fwd_kernel): the first design, every product a scalar f32
// FMA, far above the bound.  One block of 8 warps per 32-token tile loops
// over all 128-column vocab tiles, and over E in 32-wide slices staged
// through shared memory (rows padded to 33 floats).  Each warp owns 4
// tokens and each lane 4 columns (lane + 32*j), a 4x4 register tile of
// logits; the tile's max, argmax, sum-exp and label logit reduce across
// the warp with shuffles into running statistics held in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BN = 32;    // tokens per block
constexpr int BV = 128;   // vocab columns per tile
constexpr int BE = 32;    // embedding slice staged per step
constexpr int WARPS = 8;  // 4 tokens per warp
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = BN / WARPS;   // rows per warp (4)
constexpr int CPL = BV / 32;      // columns per lane (4)

__device__ __forceinline__ float to_f32(float x) { return x; }

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

cudaError_t launch_f32(const void* h, const void* w, const void* labels,
                       void* lse, void* ll, void* hit, int N, int E, int V,
                       cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN);
  head_fwd_kernel<float><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(ll), static_cast<float*>(hit), N, E, V);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores

using mma_bf16::bf16;
constexpr int MBN = 128;          // tokens per block
constexpr int MBV = 128;          // vocab columns per tile
constexpr int KC = 64;            // E columns per chunk
constexpr int STAGES = 3;         // chunks of h and W in shared memory
constexpr int MWARPS = 8;         // 4 row groups x 2 column halves
constexpr int MTHREADS = 32 * MWARPS;
constexpr float LOG2E = 1.4426950408889634f;

// one row's statistics over one range of the vocab
struct __align__(16) Partial {
  float m;     // max logit
  float d;     // sum of exp(logit - m)
  int amax;    // lowest column holding m
  float ll;    // the label's logit, 0 when the label is outside the range
};

// STAGES chunks of h (MBN rows) and of W (MBV rows), pitch KC + 8
constexpr int MMA_SMEM_BYTES =
    STAGES * (MBN + MBV) * mma_bf16::pitch<KC>() * (int)sizeof(bf16);

// (m, d, amax, ll) absorbs (m2, d2, a2, l2), two disjoint column sets:
// the larger max wins, the lower column on equal maxima
__device__ __forceinline__ void merge(float& m, float& d, int& amax,
                                     float& ll, float m2, float d2, int a2,
                                     float l2) {
  if (m2 > m || (m2 == m && a2 < amax)) amax = a2;
  const float mn = fmaxf(m, m2);
  if (mn != -INFINITY) {
    d = d * expf(m - mn) + d2 * expf(m2 - mn);
    m = mn;
  }
  ll += l2;
}

// blockIdx.x: 128-token tile; blockIdx.y: range of `split_tiles` vocab
// tiles.  Writes ws[blockIdx.y * N + n] for the block's rows n < N.
__global__ void __launch_bounds__(MTHREADS, 2)
head_fwd_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ labels,
                    Partial* __restrict__ ws, int N, int E, int V,
                    int split_tiles) {
  namespace mb = mma_bf16;
  constexpr int P = mb::pitch<KC>();
  constexpr int TILE = MBN * P;    // one stage of h (or W), in elements
  static_assert(MBN == MBV, "h and W stages share one size");
  extern __shared__ float4 smem4[];
  bf16* hs = reinterpret_cast<bf16*>(smem4);  // STAGES tiles of MBN rows
  bf16* wsm = hs + STAGES * TILE;             // STAGES tiles of MBV rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3;         // rows wr*32 .. wr*32 + 31 of the tile
  const int wc = warp >> 2;        // columns wc*64 .. wc*64 + 63
  const int n0 = blockIdx.x * MBN;
  const int nvt = (V + MBV - 1) / MBV;
  const int vt0 = blockIdx.y * split_tiles;
  const int ntile = max(min(nvt, vt0 + split_tiles) - vt0, 0);
  const int nch = (E + KC - 1) / KC;
  const int nsteps = ntile * nch;  // (vocab tile, E chunk) steps

  // this thread's rows: r = 2*mi + hf is row wr*32 + 16*mi + g + 8*hf of
  // the tile, accumulator values acc[mi][j][2*hf + e]
  float m[4], d[4], ll[4];
  int amax[4], lbl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + wr * 32 + 16 * (r >> 1) + g + 8 * (r & 1);
    lbl[r] = n < N ? labels[n] : -1;
    m[r] = -INFINITY;
    d[r] = ll[r] = 0.f;
    amax[r] = 0;
  }

  auto load = [&](int st, int buf) {
    const int vt = vt0 + st / nch, ch = st % nch;
    mb::load_tile<MBN, KC, MTHREADS>(hs + buf * TILE, h, E, n0, N, ch * KC,
                                     E);
    mb::load_tile<MBV, KC, MTHREADS>(wsm + buf * TILE, w, E, vt * MBV, V,
                                     ch * KC, E);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    mb::cp_commit();
  }

  float acc[2][8][4];
  for (int st = 0; st < nsteps; ++st) {
    const int ch = st % nch;
    if (ch == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    mb::cp_wait<STAGES - 2>();     // this step's chunks have landed
    __syncthreads();               // and every reader of the oldest is done
    if (st + STAGES - 1 < nsteps)  // a later step's copy, in flight
      load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    mb::cp_commit();

    const bf16* ht = hs + (st % STAGES) * TILE;
    const bf16* wt = wsm + (st % STAGES) * TILE + wc * 64 * P;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a0[4], a1[4];
      mb::load_a<KC>(a0, ht, wr * 32, kk * 16);
      mb::load_a<KC>(a1, ht, wr * 32 + 16, kk * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        mb::load_b<KC>(b, wt, j * 16, kk * 16);
        mb::mma(acc[0][2 * j], a0, b[0], b[1]);
        mb::mma(acc[0][2 * j + 1], a0, b[2], b[3]);
        mb::mma(acc[1][2 * j], a1, b[0], b[1]);
        mb::mma(acc[1][2 * j + 1], a1, b[2], b[3]);
      }
    }
    if (ch != nch - 1) continue;

    // fold this vocab tile into each row's running statistics; value
    // acc[mi][j][2*hf + e] is column v0 + 8j + 2t + e
    const int v0 = (vt0 + st / nch) * MBV + wc * 64;
    const bool edge = v0 + 64 > V;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int mi = r >> 1, hf = r & 1;
      float tm = -INFINITY;
      int tc = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 8 * j + 2 * t + e;
          const float x = acc[mi][j][2 * hf + e];
          if ((!edge || col < V) && x > tm) {  // ascending: lowest wins
            tm = x;
            tc = col;
          }
        }
      if (lbl[r] >= v0 && lbl[r] < v0 + 64) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v0 + 8 * j + 2 * t + e == lbl[r])
              ll[r] = acc[mi][j][2 * hf + e];
      }
      if (tm > m[r]) amax[r] = tc;
      const float mn = fmaxf(m[r], tm);
      if (mn != -INFINITY) {
        const float mb2 = mn * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!edge || v0 + 8 * j + 2 * t + e < V)
              sum += mb::exp2_approx(
                  fmaf(acc[mi][j][2 * hf + e], LOG2E, -mb2));
        d[r] = d[r] * mb::exp2_approx((m[r] - mn) * LOG2E) + sum;
        m[r] = mn;
      }
    }
  }

  // merge the quad's four column sets, then the two column halves
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      merge(m[r], d[r], amax[r], ll[r],
            __shfl_xor_sync(0xffffffffu, m[r], off),
            __shfl_xor_sync(0xffffffffu, d[r], off),
            __shfl_xor_sync(0xffffffffu, amax[r], off),
            __shfl_xor_sync(0xffffffffu, ll[r], off));
  mb::cp_wait<0>();
  __syncthreads();                 // the stages are free: reuse them
  Partial* upper = reinterpret_cast<Partial*>(smem4);  // MBN rows
  if (wc == 1 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      upper[wr * 32 + 16 * (r >> 1) + g + 8 * (r & 1)] =
          Partial{m[r], d[r], amax[r], ll[r]};
  }
  __syncthreads();
  if (wc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wr * 32 + 16 * (r >> 1) + g + 8 * (r & 1);
      const Partial o = upper[row];
      merge(m[r], d[r], amax[r], ll[r], o.m, o.d, o.amax, o.ll);
      if (n0 + row < N)
        ws[(long)blockIdx.y * N + n0 + row] =
            Partial{m[r], d[r], amax[r], ll[r]};
    }
  }
}

// one thread per row: the partials of the `splits` vocab ranges in V
// order; a later range holds higher columns, so `merge` takes its argmax
// only when strictly greater
__global__ void head_merge_kernel(const Partial* __restrict__ ws,
                                  const int* __restrict__ labels,
                                  float* __restrict__ lse_out,
                                  float* __restrict__ ll_out,
                                  float* __restrict__ hit_out, int N,
                                  int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = -INFINITY, d = 0.f, ll = 0.f;
  int amax = 0;
  for (int s = 0; s < splits; ++s) {
    const Partial p = ws[(long)s * N + n];
    merge(m, d, amax, ll, p.m, p.d, p.amax, p.ll);
  }
  lse_out[n] = m + logf(d);
  ll_out[n] = ll;
  hit_out[n] = amax == labels[n] ? 1.f : 0.f;
}

cudaError_t launch_bf16(const void* h, const void* w, const void* labels,
                        void* lse, void* ll, void* hit, void* ws, int N,
                        int E, int V, int split_tiles, cudaStream_t stream) {
  // 16-byte copies: E a multiple of 8, h and W on 16 bytes
  const bool aligned = ((reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(ws)) & 15) == 0;
  const int nvt = (V + MBV - 1) / MBV;
  if (E % 8 != 0 || !aligned || split_tiles < 1)
    return cudaErrorInvalidValue;
  const int splits = (nvt + split_tiles - 1) / split_tiles;
  if (splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MMA_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + MBN - 1) / MBN, splits);
  head_fwd_mma_kernel<<<grid, MTHREADS, MMA_SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<Partial*>(ws), N, E, V,
      split_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_merge_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      static_cast<const Partial*>(ws), static_cast<const int*>(labels),
      static_cast<float*>(lse), static_cast<float*>(ll),
      static_cast<float*>(hit), N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar body; ws and split_tiles unused),
// 1 = bfloat16 (tensor-core body): ws holds ceil(ceil(V/128) /
// split_tiles) * N partials of 16 bytes, one per (vocab range, row), each
// range `split_tiles` tiles of 128 columns.  Returns a cudaError_t.
int head_fwd(const void* h, const void* w, const void* labels, void* lse,
             void* ll, void* hit, void* ws, int N, int E, int V,
             int split_tiles, int dtype, void* stream) {
  if (N < 1 || E < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(h, w, labels, lse, ll, hit, N, E, V, st);
  if (dtype == 1)
    return (int)launch_bf16(h, w, labels, lse, ll, hit, ws, N, E, V,
                            split_tiles, st);
  return (int)cudaErrorInvalidValue;
}

const char* head_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
