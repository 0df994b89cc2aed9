// Gibbs (nonstationary RBF) gram for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, gibbs_pallas -> _gibbs_forward -> _gibbs_kernel_body.
//
//   K[s, n, m] = scale2 * sqrt(2 l1 l2 / (l1^2 + l2^2)) * exp(-|x1 - x2|^2 / (l1^2 + l2^2))
//   with l1 = ell1[s, n], l2 = ell2[s, m]; x1 (N, d), x2 (M, d), d <= 4.
//
// Bound on the H100: bytes.  Each output element costs one 4-byte store and
// about 2d + 8 FP32 operations (one exp, one sqrt, one reciprocal), far
// under the ~20 FLOP/byte the card needs before arithmetic is the limit.
// The inputs are vectors of N + M entries per draw, so the store of the
// (S, N, M) gram is the whole cost: 16.8 MB at SNMGP's (4, 1024, 1024), 5.0
// us at 3.35 TB/s.  At the path's small shapes ((4, 100, 100), (8, 512,
// 100)) a launch's own cost is the floor.
//
// Design: the output is one flat array of S N M floats, and each thread
// writes four consecutive elements of it with one 16-byte store (the last
// S N M mod 4 by a scalar tail), in a grid-stride loop over a grid sized to
// the card's SMs.  No lane is spent on padding columns and no tile is
// staged: a thread reads its row's x1 and l1 and its four columns' x2 and
// l2 straight from global memory (a few hundred bytes in all, L1-resident),
// so it waits at no barrier before it stores.  Where M is a multiple of 4
// the four elements share one row; elsewhere they may cross into the next
// row, which the thread follows.  One reciprocal of the denominator serves
// both of its uses (the TPU kernel's `inv`), each quotient corrected once
// by its residual, and the exponential stays expf at full precision: the
// gate is rtol 1e-5 against the plain version, and far out on the
// exponential (arguments of 60-87 at (4, 1024, 1024) on the ECoG axis) one
// ulp of the argument is already ~1e-5 of the entry, so every step is
// rounded as the plain version rounds it (`gibbs_entry`).  The squared
// distance is the exact broadcast difference, as in ops.kernels.sq_dist for
// d <= 4.  On the H100 the correction cost little against rounding the
// quotients once, and dividing was slower (PERF.md has the kernel's times,
// from chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 4;
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 16;  // the grid: 16 blocks of 128 threads an SM, then stride

// n / den from the shared reciprocal inv = 1 / den, the product corrected
// once by its residual, as a division is.
__device__ __forceinline__ float quotient(float n, float den, float inv) {
  const float q = __fmul_rn(n, inv);
  return fmaf(fmaf(-q, den, n), inv, q);
}

// One entry, rounded step by step as the plain version rounds it (no
// contraction into FMAs): far out on the exponential an ulp of the
// exponent's argument is ~1e-5 of the entry, the gate's whole tolerance.
template <int D>
__device__ __forceinline__ float gibbs_entry(const float* __restrict__ x1,
                                             const float* __restrict__ x2, float a, float b,
                                             int row, int col, float scale2) {
  float d2 = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float diff = __fsub_rn(__ldg(x1 + (size_t)row * D + k), __ldg(x2 + (size_t)col * D + k));
    d2 = k == 0 ? __fmul_rn(diff, diff) : __fadd_rn(d2, __fmul_rn(diff, diff));
  }
  const float den = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
  const float inv = __frcp_rn(den);
  const float pref = sqrtf(quotient(2.0f * __fmul_rn(a, b), den, inv));
  return __fmul_rn(__fmul_rn(scale2, pref), expf(quotient(-d2, den, inv)));
}

// x / d for 0 <= x < 2^53 by a double product and one correction, in place
// of a 64-bit integer division (tens of instructions).
__device__ __forceinline__ long long div_by(long long x, long long d, double inv_d) {
  long long q = (long long)((double)x * inv_d);
  const long long r = x - q * d;
  return r < 0 ? q - 1 : (r >= d ? q + 1 : q);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    gibbs_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ l1, const float* __restrict__ l2, float scale2,
                 float* __restrict__ out, int n, int m, long long total, int vec_l2) {
  const long long quads = total / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const double inv_n = 1.0 / n, inv_m = 1.0 / m;
  // the element at flat index e, on row sr = e / m of the S N rows: l1 is
  // (S, N) contiguous, so its entry is l1[sr]; point sr % n, draw sr / n
  auto at = [&](long long e) {
    const long long sr = div_by(e, m, inv_m), sd = div_by(sr, n, inv_n);
    const int col = (int)(e - sr * m);
    return gibbs_entry<D>(x1, x2, __ldg(l1 + sr), __ldg(l2 + sd * m + col), (int)(sr - sd * n),
                          col, scale2);
  };
  if (m % 4 == 0) {  // four outputs share one row: one draw, one l1, one x1
    const int mq = m / 4;
    const double inv_mq = 1.0 / mq;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads; i += stride) {
      const long long sr = div_by(i, mq, inv_mq), sd = div_by(sr, n, inv_n);
      const int col = 4 * (int)(i - sr * mq), row = (int)(sr - sd * n);
      const float a = __ldg(l1 + sr);
      const float* l2c = l2 + sd * m + col;
      const float4 b = vec_l2 ? __ldg(reinterpret_cast<const float4*>(l2c))
                              : make_float4(__ldg(l2c), __ldg(l2c + 1), __ldg(l2c + 2), __ldg(l2c + 3));
      *reinterpret_cast<float4*>(out + 4 * i) =
          make_float4(gibbs_entry<D>(x1, x2, a, b.x, row, col, scale2),
                      gibbs_entry<D>(x1, x2, a, b.y, row, col + 1, scale2),
                      gibbs_entry<D>(x1, x2, a, b.z, row, col + 2, scale2),
                      gibbs_entry<D>(x1, x2, a, b.w, row, col + 3, scale2));
    }
  } else {  // four outputs may cross into the next row
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads; i += stride) {
      const long long e = 4 * i;
      *reinterpret_cast<float4*>(out + e) = make_float4(at(e), at(e + 1), at(e + 2), at(e + 3));
    }
    // the last total mod 4 elements
    const long long tail = 4 * quads + blockIdx.x * blockDim.x + threadIdx.x;
    if (tail < total) out[tail] = at(tail);
  }
}

template <int D>
int launch(const float* x1, const float* x2, const float* l1, const float* l2, float scale2,
           float* out, int n, int m, long long total, cudaStream_t st) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  const long long need = (total / 4 + kThreads - 1) / kThreads;
  const long long cap = (long long)kBlocksPerSM * sms;
  const unsigned blocks = (unsigned)(need < 1 ? 1 : (need < cap ? need : cap));
  gibbs_kernel<D><<<blocks, kThreads, 0, st>>>(x1, x2, l1, l2, scale2, out, n, m, total,
                                                (uintptr_t)l2 % 16 == 0);
  return (int)cudaGetLastError();
}

}  // namespace

// x1 (n, d), x2 (m, d), l1 (s, n), l2 (s, m), out (s, n, m); all float32,
// contiguous, on the stream's device, out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int gibbs_launch(const float* x1, const float* x2, const float* l1, const float* l2,
                            float scale2, float* out, int s, int n, int m, int d,
                            void* stream) {
  if (d < 1 || d > kMaxDim || n < 1 || m < 1 || s < 1 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)s * n * m;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch<1>(x1, x2, l1, l2, scale2, out, n, m, total, st);
    case 2: return launch<2>(x1, x2, l1, l2, scale2, out, n, m, total, st);
    case 3: return launch<3>(x1, x2, l1, l2, scale2, out, n, m, total, st);
    default: return launch<4>(x1, x2, l1, l2, scale2, out, n, m, total, st);
  }
}
