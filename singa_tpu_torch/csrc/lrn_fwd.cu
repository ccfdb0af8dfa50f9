// Cross-channel LRN forward for Hopper (sm_90a), with the ReLU fused in
// front when asked:
//   a = relu ? max(x, 0) : x
//   n = k + (alpha/L) * sum_{|j-c| <= L/2} a_j^2,   y = a * n^-beta
//
// Replaces the TPU kernel `_fwd_kernel` (singa_tpu/ops/lrn_pallas.py:62,
// launched by `lrn_fwd_pallas`, :143).  Same arithmetic, roundings
// included: a*a rounded to x's type, the window sum in f32, n and p in
// f32 (p = r*sqrt(r), r = rsqrt(n) for beta = 0.75), y = a*p rounded to
// x's type.  Products and sums go through the _rn intrinsics so nvcc
// contracts nothing into an FMA that the plain version
// (singa_tpu_torch/ops/lrn.py `lrn_fwd_plain`) does not have.
//
// What bounds it on this card: memory.  It reads x once and writes y once
// (norm1 of AlexNet-CIFAR10 at B=1024: 67.1 M bf16 elements, 268 MB,
// ~0.080 ms at 3.35 TB/s); its ~2L+10 flops per element are far below the
// card's rate.
//
// Design against that bound, and what differs from the TPU kernel: the TPU
// kernel transposes to a batch-in-lanes (H*W, C, N) layout and runs the
// window sum as a band matmul on the MXU.  Here the activation is
// contiguous NHWC, so a tile of pixels is one contiguous run: the block
// reads it once with coalesced loads, keeps a in registers, stages a*a in
// shared memory, and each thread sums its outputs' windows from there.
// No layout change, no second read of x, any C and any N (the TPU kernel
// needs N % 128 == 0 and C % 8 == 0).  Vector loads and a
// multi-tile-per-block loop are later work.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

template <typename T, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int P, int C,
               int tp, int half, float coef, float knorm, float beta,
               int b075) {
  extern __shared__ float sq[];  // the tile's a*a, rounded to T
  const long long p0 = (long long)blockIdx.x * tp;
  const int np = (int)min((long long)tp, (long long)P - p0);
  const int n_el = np * C;
  const long long base = p0 * C;

  float a[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    a[k] = 0.f;
    if (idx < n_el) {
      float v = to_f32(x[base + idx]);
      if (RELU) v = fmaxf(v, 0.f);
      a[k] = v;
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
      y[base + idx] = from_f32<T>(__fmul_rn(a[k], p_of_n(n, beta, b075)));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int P, int C, int local_size,
                   double alpha, double beta, double knorm, int relu,
                   cudaStream_t stream) {
  const Geometry g = geometry(P, C);
  const size_t smem = sizeof(float) * g.tp * C;
  const float coef = (float)(alpha / local_size);
  const int b075 = beta == 0.75;
  auto kernel = relu ? lrn_fwd_kernel<T, true> : lrn_fwd_kernel<T, false>;
  kernel<<<g.blocks, g.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), P, C, g.tp,
      local_size / 2, coef, (float)knorm, (float)beta, b075);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (P, C) channels-last; dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int lrn_fwd(const void* x, void* y, int P, int C, int local_size,
            double alpha, double beta, double knorm, int relu, int dtype,
            void* stream) {
  if (bad_args(P, C, local_size)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, y, P, C, local_size, alpha, beta, knorm,
                              relu, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, y, P, C, local_size, alpha, beta,
                                      knorm, relu, st);
  return (int)cudaErrorInvalidValue;
}

const char* lrn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
