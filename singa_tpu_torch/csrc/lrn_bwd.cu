// Cross-channel LRN backward for Hopper (sm_90a), the closed form of the
// reference (layer.cc:366-377), with the fused ReLU's mask:
//   a = relu ? max(x, 0) : x,  n and p = n^-beta as in the forward
//   t = (g*a) * (p/n)                       (rounded to x's type)
//   u = sum_{|j-c| <= L/2} t_j
//   da = g*p - 2*beta*(alpha/L) * a * u,    zeroed where x <= 0 if relu
//
// Replaces the TPU kernel `_bwd_kernel` (singa_tpu/ops/lrn_pallas.py:70,
// launched by `lrn_bwd_pallas`, :159).  Same arithmetic, roundings
// included: g*a rounded to x's type, then times p/n in f32, and t rounded
// to x's type again before the second window sum (lrn_pallas.py:78); u
// and da in f32, da rounded to x's type.  The plain version is
// `lrn_bwd_plain` in singa_tpu_torch/ops/lrn.py.
//
// What bounds it on this card: memory.  It reads x and g once and writes
// dx once (norm1 of AlexNet-CIFAR10 at B=1024: 403 MB in bf16, ~0.120 ms
// at 3.35 TB/s).
//
// Design: as the forward (lrn_common.cuh): a block owns a contiguous tile
// of pixels, keeps a, g and p of its elements in registers, and stages
// a*a in shared memory for the first window sum.  It recomputes s, n and p
// (nothing but x is saved by the forward), writes t to a second shared
// array, synchronises, and takes u from there.  Every output has one
// writer: no atomics, and the result does not depend on the schedule.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

template <typename T, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, int P, int C, int tp, int half,
               float coef, float knorm, float beta, int b075, float c2) {
  extern __shared__ float smem[];
  float* sq = smem;            // the tile's a*a, rounded to T
  float* ts = smem + tp * C;   // the tile's t, rounded to T
  const long long p0 = (long long)blockIdx.x * tp;
  const int np = (int)min((long long)tp, (long long)P - p0);
  const int n_el = np * C;
  const long long base = p0 * C;

  float a[EPT], gv[EPT], p[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    a[k] = gv[k] = p[k] = 0.f;
    if (idx < n_el) {
      float v = to_f32(x[base + idx]);
      if (RELU) v = fmaxf(v, 0.f);
      a[k] = v;
      gv[k] = to_f32(g[base + idx]);
      sq[idx] = mul_t<T>(v, v);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    if (idx < n_el) {
      const int c = idx % C;
      const float s = window_sum(sq + (idx - c), c, C, half);
      const float n = __fadd_rn(__fmul_rn(s, coef), knorm);
      p[k] = p_of_n(n, beta, b075);
      const float t = __fmul_rn(mul_t<T>(gv[k], a[k]), __fdiv_rn(p[k], n));
      ts[idx] = to_f32(from_f32<T>(t));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    if (idx < n_el) {
      const int c = idx % C;
      const float u = window_sum(ts + (idx - c), c, C, half);
      float da = __fsub_rn(__fmul_rn(gv[k], p[k]),
                           __fmul_rn(__fmul_rn(c2, a[k]), u));
      if (RELU && !(a[k] > 0.f)) da = 0.f;  // x > 0 exactly where a > 0
      dx[base + idx] = from_f32<T>(da);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* dx, int P, int C,
                   int local_size, double alpha, double beta, double knorm,
                   int relu, cudaStream_t stream) {
  const Geometry geo = geometry(P, C);
  const size_t smem = 2 * sizeof(float) * geo.tp * C;
  const float coef = (float)(alpha / local_size);
  // 2*beta*(alpha/L) in double, rounded once, as the Python constant is
  const float c2 = (float)(2.0 * beta * (alpha / local_size));
  const int b075 = beta == 0.75;
  auto kernel = relu ? lrn_bwd_kernel<T, true> : lrn_bwd_kernel<T, false>;
  kernel<<<geo.blocks, geo.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      P, C, geo.tp, local_size / 2, coef, (float)knorm, (float)beta, b075,
      c2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, g, dx: (P, C) channels-last; dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int lrn_bwd(const void* x, const void* g, void* dx, int P, int C,
            int local_size, double alpha, double beta, double knorm,
            int relu, int dtype, void* stream) {
  if (bad_args(P, C, local_size)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, g, dx, P, C, local_size, alpha, beta, knorm,
                              relu, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, g, dx, P, C, local_size, alpha, beta,
                                      knorm, relu, st);
  return (int)cudaErrorInvalidValue;
}

const char* lrn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
