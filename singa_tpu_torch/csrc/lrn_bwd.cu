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
// and da in f32, da rounded to x's type.  For beta = 0.75, p/n is
// (p*r)*r and rsqrt and sqrt are the special-function unit's
// approximations (lrn_common.cuh `norm_pow_075`), within phase 8's
// tolerances of the plain version, `lrn_bwd_plain` in
// singa_tpu_torch/ops/lrn.py, which divides.
//
// What bounds it on this card: memory, by the count.  It reads x and g
// once and writes dx once (norm1 of AlexNet-CIFAR10 at B=1024: 403 MB in
// bf16, ~0.120 ms at 3.35 TB/s); its ~55 instructions per element (two
// window sums, three roundings, the conversions) take longer to issue
// than the bytes take to move.
//
// Design: the forward's two routes (lrn_fwd.cu, lrn_common.cuh), picked
// in the C entry by shape and alignment.  Nothing but x is saved by the
// forward, so each element recomputes s, n and p; t goes to a second
// staged row for the second window sum.
//
// vector (C % 8 == 0, pointers on 16 bytes): a thread owns 8 channels of
// one pixel, loads x and g with one 16-byte access each (two in f32),
// stages a*a in a zero-padded f32 row, takes s from 16-byte shared loads
// with no bounds checks, keeps g*p, (2*beta*alpha/L)*a and the ReLU mask
// of its 8 elements in registers, stages t in a second padded row, and
// takes u the same way: two barriers a tile, and each row is rewritten
// only after both barriers of the tile that last read it.  Blocks are
// persistent, and each thread's loads of its next tile are in flight
// while it computes the current one.  L = 3, 5, 7, 9 with beta = 0.75
// and C <= 2048 take bodies unrolled over the window with no powf and no
// division; any other L, beta or C the same body with runtime loops.
//
// general (any C up to 6144, any alignment): the first design.  A block
// owns a contiguous tile of pixels, keeps a, g and p of its elements in
// registers, stages a*a and then t in shared memory, with bounds checks
// in the window.
//
// Every output has one writer: no atomics, and the result does not depend
// on the schedule.

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
      const NormPow np = norm_pow(n, beta, b075);
      p[k] = np.p;
      const float t = __fmul_rn(mul_t<T>(gv[k], a[k]), np.q);
      ts[idx] = round_t<T>(t);
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

// Vector route.  HALF >= 0: L = 2*HALF + 1 and beta = 0.75, unrolled;
// HALF < 0: runtime half-window and beta.
template <typename T, bool RELU, int HALF>
__global__ void __launch_bounds__(HALF >= 0 ? THREADS : MAX_THREADS,
                                  HALF >= 0 ? 4 : 1)
lrn_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, int P, int C, int tp, int tiles,
                   int half, int pad, float coef, float knorm, float beta,
                   int b075, float c2) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // tp rows of a*a, tp of t
  const int pitch = C + 2 * pad;
  const int v = C / VEC;
  const int pix = threadIdx.x / v;
  const int c0 = (threadIdx.x - pix * v) * VEC;  // fixed for the kernel
  for (int r = threadIdx.x; r < 2 * tp; r += blockDim.x)
    for (int j = 0; j < pad; ++j)
      sm[r * pitch + j] = sm[r * pitch + pad + C + j] = 0.f;
  float* sq_row = sm + pix * pitch;
  float* t_row = sm + (tp + pix) * pitch;

  Raw8<T> rx, rg;
  zero8(rx);
  zero8(rg);
  long p = (long)blockIdx.x * tp + pix;
  if (p < P) {
    load8(rx, x + p * C + c0);
    load8(rg, g + p * C + c0);
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    p = (long)tile * tp + pix;
    float a[VEC], gv[VEC];
    unpack8(a, rx);              // zeros past P
    unpack8(gv, rg);
    // the next tile's loads, in flight while this one is computed
    const long pn = p + (long)gridDim.x * tp;
    zero8(rx);
    zero8(rg);
    if (tile + (int)gridDim.x < tiles && pn < P) {
      load8(rx, x + pn * C + c0);
      load8(rg, g + pn * C + c0);
    }
    unsigned keep = 0xffu;       // the ReLU's mask: x > 0 where a > 0
    float sq[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (RELU) {
        a[i] = fmaxf(a[i], 0.f);
        if (!(a[i] > 0.f)) keep &= ~(1u << i);
      }
      sq[i] = mul_t<T>(a[i], a[i]);
    }
    stage8(sq_row + pad + c0, sq);
    __syncthreads();             // a*a staged; last tile's t rows read
    float w[VEC];
    window8<HALF>(w, sq_row, c0, half, pad);
    float t[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float n = __fadd_rn(__fmul_rn(w[i], coef), knorm);
      const NormPow np =
          HALF >= 0 ? norm_pow_075(n) : norm_pow(n, beta, b075);
      t[i] = round_t<T>(__fmul_rn(mul_t<T>(gv[i], a[i]), np.q));
      gv[i] = __fmul_rn(gv[i], np.p);      // g*p
      a[i] = __fmul_rn(c2, a[i]);          // 2*beta*(alpha/L)*a
    }
    stage8(t_row + pad + c0, t);
    __syncthreads();             // t staged; this tile's a*a rows read
    window8<HALF>(w, t_row, c0, half, pad);
    if (p < P) {
      float da[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        da[i] = __fsub_rn(gv[i], __fmul_rn(a[i], w[i]));
        if (RELU && !((keep >> i) & 1u)) da[i] = 0.f;
      }
      store8(dx + p * C + c0, da);
    }
  }
}

template <typename T, bool RELU>
cudaError_t launch_vec(const T* x, const T* g, T* dx, int P, int C,
                       int local_size, float coef, float knorm, double beta,
                       float c2, cudaStream_t stream) {
  const int half = local_size / 2;
  const VecGeometry geo = vec_geometry(P, C, half);
  const size_t smem = sizeof(float) * 2 * geo.tp * geo.pitch;
  const int b075 = beta == 0.75;
  const float fbeta = (float)beta;
  auto go = [&](auto kernel) {
    return launch_persistent(kernel, geo.threads, smem, geo.tiles, stream,
                             x, g, dx, P, C, geo.tp, geo.tiles, half,
                             geo.pad, coef, knorm, fbeta, b075, c2);
  };
  switch (unrolled_half(C, local_size, beta)) {
    case 1: return go(lrn_bwd_vec_kernel<T, RELU, 1>);
    case 2: return go(lrn_bwd_vec_kernel<T, RELU, 2>);
    case 3: return go(lrn_bwd_vec_kernel<T, RELU, 3>);
    case 4: return go(lrn_bwd_vec_kernel<T, RELU, 4>);
    default: return go(lrn_bwd_vec_kernel<T, RELU, -1>);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* dx, int P, int C,
                   int local_size, double alpha, double beta, double knorm,
                   int relu, cudaStream_t stream) {
  const float coef = (float)(alpha / local_size);
  // 2*beta*(alpha/L) in double, rounded once, as the Python constant is
  const float c2 = (float)(2.0 * beta * (alpha / local_size));
  if (vec_ok(C, x, g, dx)) {
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(g);
    T* dxt = static_cast<T*>(dx);
    return relu ? launch_vec<T, true>(xt, gt, dxt, P, C, local_size, coef,
                                      (float)knorm, beta, c2, stream)
                : launch_vec<T, false>(xt, gt, dxt, P, C, local_size, coef,
                                       (float)knorm, beta, c2, stream);
  }
  const Geometry geo = geometry(P, C);
  const size_t smem = 2 * sizeof(float) * geo.tp * C;
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

// x, g, dx: (P, C) channels-last; dtype: 0 = float32, 1 = bfloat16.  The
// vector route runs when C % 8 == 0 and x, g and dx start on 16 bytes,
// the general route otherwise.  Returns a cudaError_t.
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
