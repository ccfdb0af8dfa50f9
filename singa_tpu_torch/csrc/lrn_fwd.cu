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
// (singa_tpu_torch/ops/lrn.py `lrn_fwd_plain`) does not have; rsqrt and
// sqrt are the special-function unit's approximations (lrn_common.cuh
// `norm_pow_075`), within phase 8's tolerances of the plain version.
//
// What bounds it on this card: memory, by the count.  It reads x once and
// writes y once (norm1 of AlexNet-CIFAR10 at B=1024: 67.1 M bf16
// elements, 268 MB, ~0.080 ms at 3.35 TB/s); its ~2L+10 flops per element
// are far below the card's f32 rate, but its ~35 instructions per element
// (conversions, roundings, the window's loads and adds) issue in about
// the same time as the bytes move.
//
// Design against that bound, and what differs from the TPU kernel: the TPU
// kernel transposes to a batch-in-lanes (H*W, C, N) layout and runs the
// window sum as a band matmul on the MXU.  Here the activation is
// contiguous NHWC, so a tile of pixels is one contiguous run, read once
// with coalesced loads: no layout change, no second read of x.  Two
// routes (lrn_common.cuh), picked in the C entry by shape and alignment:
//
// vector (C % 8 == 0, pointers on 16 bytes; AlexNet's 64 and 192
// channels and every shape the TPU kernel takes): a thread owns 8
// channels of one pixel, loads them with one 16-byte access (two in f32),
// stages their a*a in a zero-padded f32 row in shared memory (double
// buffered, so one barrier a tile), sums its 8 windows from 16-byte
// shared loads with no bounds checks, and stores 8 outputs with one
// access.  Blocks are persistent, and each thread's loads of its next
// tile are in flight while it computes the current one.  L = 3, 5, 7, 9 with beta = 0.75 and C <= 2048
// take bodies unrolled over the window with p = r*sqrt(r) and no powf;
// any other L, beta or C takes the same body with runtime loops.
//
// general (any C up to 6144, any alignment): the first design.  A block
// owns one tile, keeps a in registers, stages a*a in shared memory, and
// each thread sums its outputs' windows from there with bounds checks.
//
// Any N and any C (the TPU kernel needs N % 128 == 0 and C % 8 == 0).

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
      y[base + idx] =
          from_f32<T>(__fmul_rn(a[k], norm_pow(n, beta, b075).p));
    }
  }
}

// Vector route.  HALF >= 0: L = 2*HALF + 1 and beta = 0.75, unrolled;
// HALF < 0: runtime half-window and beta.
template <typename T, bool RELU, int HALF>
__global__ void __launch_bounds__(HALF >= 0 ? THREADS : MAX_THREADS,
                                  HALF >= 0 ? 4 : 1)
lrn_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int P, int C,
                   int tp, int tiles, int half, int pad, float coef,
                   float knorm, float beta, int b075) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // 2 buffers of tp rows
  const int pitch = C + 2 * pad;
  const int v = C / VEC;
  const int pix = threadIdx.x / v;
  const int c0 = (threadIdx.x - pix * v) * VEC;  // fixed for the kernel
  // the zero pads of every row, once: tiles write only the interiors
  for (int r = threadIdx.x; r < 2 * tp; r += blockDim.x)
    for (int j = 0; j < pad; ++j)
      sm[r * pitch + j] = sm[r * pitch + pad + C + j] = 0.f;

  Raw8<T> raw;
  zero8(raw);
  long p = (long)blockIdx.x * tp + pix;
  if (p < P) load8(raw, x + p * C + c0);
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    p = (long)tile * tp + pix;
    float a[VEC];
    unpack8(a, raw);             // zeros past P
    if (RELU) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[i] = fmaxf(a[i], 0.f);
    }
    // the next tile's loads, in flight while this one is computed
    const long pn = p + (long)gridDim.x * tp;
    zero8(raw);
    if (tile + (int)gridDim.x < tiles && pn < P)
      load8(raw, x + pn * C + c0);
    float* row = sm + (buf * tp + pix) * pitch;
    float sq[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sq[i] = mul_t<T>(a[i], a[i]);
    stage8(row + pad + c0, sq);
    __syncthreads();             // the other buffer is written next tile
    float s[VEC];
    window8<HALF>(s, row, c0, half, pad);
    if (p < P) {
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float n = __fadd_rn(__fmul_rn(s[i], coef), knorm);
        const float pw = (HALF >= 0 ? norm_pow_075(n)
                                    : norm_pow(n, beta, b075)).p;
        out[i] = __fmul_rn(a[i], pw);
      }
      store8(y + p * C + c0, out);
    }
    buf ^= 1;
  }
}

template <typename T, bool RELU>
cudaError_t launch_vec(const T* x, T* y, int P, int C, int local_size,
                       float coef, float knorm, double beta,
                       cudaStream_t stream) {
  const int half = local_size / 2;
  const VecGeometry g = vec_geometry(P, C, half);
  const size_t smem = sizeof(float) * 2 * g.tp * g.pitch;
  const int b075 = beta == 0.75;
  const float fbeta = (float)beta;
  auto go = [&](auto kernel) {
    return launch_persistent(kernel, g.threads, smem, g.tiles, stream, x, y,
                             P, C, g.tp, g.tiles, half, g.pad, coef, knorm,
                             fbeta, b075);
  };
  switch (unrolled_half(C, local_size, beta)) {
    case 1: return go(lrn_fwd_vec_kernel<T, RELU, 1>);
    case 2: return go(lrn_fwd_vec_kernel<T, RELU, 2>);
    case 3: return go(lrn_fwd_vec_kernel<T, RELU, 3>);
    case 4: return go(lrn_fwd_vec_kernel<T, RELU, 4>);
    default: return go(lrn_fwd_vec_kernel<T, RELU, -1>);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int P, int C, int local_size,
                   double alpha, double beta, double knorm, int relu,
                   cudaStream_t stream) {
  const float coef = (float)(alpha / local_size);
  if (vec_ok(C, x, y, y)) {
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    return relu ? launch_vec<T, true>(xt, yt, P, C, local_size, coef,
                                      (float)knorm, beta, stream)
                : launch_vec<T, false>(xt, yt, P, C, local_size, coef,
                                       (float)knorm, beta, stream);
  }
  const Geometry g = geometry(P, C);
  const size_t smem = sizeof(float) * g.tp * C;
  const int b075 = beta == 0.75;
  auto kernel = relu ? lrn_fwd_kernel<T, true> : lrn_fwd_kernel<T, false>;
  kernel<<<g.blocks, g.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), P, C, g.tp,
      local_size / 2, coef, (float)knorm, (float)beta, b075);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (P, C) channels-last; dtype: 0 = float32, 1 = bfloat16.  The
// vector route runs when C % 8 == 0 and x and y start on 16 bytes, the
// general route otherwise.  Returns a cudaError_t.
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
