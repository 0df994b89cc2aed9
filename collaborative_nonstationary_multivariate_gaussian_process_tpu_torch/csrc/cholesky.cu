// Batched lower Cholesky factor for Hopper (sm_90a), on two routes.
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, cholesky_pallas -> _chol_forward -> _chol_kernel_body
//   (in the port: the forward of ops/linalg.cholesky, which serves the
//   jnp.linalg.cholesky sites of models/logdensities.py: the whitening factors,
//   the SVC L-prior, the dense NUTS metric).
//
// Bound on the H100: a matrix costs M^3/6 FMAs (M^3/3 flops) and
// (M (M + 1) / 2 + M^2) x 4 bytes (read K's lower triangle, write L): at
// (2, 1024, 1024) 0.72 GFLOP, 11 us at the 67 TFLOP/s FP32 rate, and 12.6 MB,
// 4 us of HBM time.  The column recurrence is sequential: M / NB block steps,
// each a chain of dependent work, so small matrices are bound by latency.
//
// Route "one_block" (small M): one matrix per block (512 threads), the
// blocked right-looking factor of csrc/chol_blocked.cuh in place on the
// output, in cuSOLVER's batched arithmetic (two levels, 64 and 16).  Few launches and no grid-wide step, but one SM per matrix: at
// (2, 1024, 1024) the trailing updates run on 2 of the 132 SMs.
//
// Route "multi_cta" (M at or above the measured crossover, ops/cuda_kernels.py):
// each matrix spread over many CTAs by the blocked right-looking factor of
// csrc/chol_multi_cta.cuh (a panel and an update launch per block column of
// 32, all enqueued by one call; at (2, 1024, 1024) the first step has 272
// update tiles).  One cooperative kernel with a grid-wide barrier between
// the phases was measured against it and dropped: equal at (2, 1024, 1024)
// and 36% slower at (4, 2048, 2048) on the H100 (PERF.md).
//
// Failure semantics follow jnp.linalg.cholesky as the port's cholesky_nan
// has them: a pivot that is <= 0 or not finite makes the member's lower
// triangle NaN; zeros above the diagonal in every member.
#include <cuda_runtime.h>

#include "chol_blocked.cuh"
#include "chol_multi_cta.cuh"

namespace {

// ---- route "one_block"

__global__ void __launch_bounds__(chol_blocked::kThreads)
    cholesky_kernel(const float* __restrict__ a, float* l, int m) {
  extern __shared__ float smem[];
  const size_t base = (size_t)blockIdx.x * m * m;
  float* L = l + base;
  const int mm = m * m;
  for (int idx = threadIdx.x; idx < mm; idx += blockDim.x)
    L[idx] = (idx % m <= idx / m) ? a[base + idx] : 0.0f;
  __syncthreads();
  const bool ok = chol_blocked::factor(L, m, smem);
  __syncthreads();
  if (!ok) {
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = threadIdx.x; idx < mm; idx += blockDim.x)
      if (idx % m <= idx / m) L[idx] = nan;
  }
}

}  // namespace

// Largest m the multi-CTA route takes (any device), and the one-block
// route's on the current device (-1 if the device cannot be queried).
extern "C" int cholesky_max_m() { return chol_multi_cta::kMaxM; }
extern "C" int cholesky_one_block_max_m() { return chol_blocked::max_m(); }

// a, l: (batch, m, m) float32, contiguous; flags: (batch,) int32 zeros and
// diag: (batch, ceil(m / 32), 32, 32) float32 scratch (the multi-CTA route's
// failure flags and factored diagonal blocks).  route 0: one block per matrix, m <=
// cholesky_one_block_max_m(); 1: multi-CTA, m <= cholesky_max_m().  Returns
// cudaGetLastError() (or the first error of a launch or an opt-in).
extern "C" int cholesky_launch(const float* a, float* l, int* flags, float* diag, int batch, int m,
                               int route, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0)
    return chol_blocked::launch(cholesky_kernel, batch, m, st, a, l, m);
  if (m < 1 || m > chol_multi_cta::kMaxM || batch > 65535) return (int)cudaErrorInvalidValue;
  if (route != 1) return (int)cudaErrorInvalidValue;
  const int threads = chol_multi_cta::kThreads, copy_blocks = (m * m + threads - 1) / threads;
  chol_multi_cta::copy_lower<<<dim3(copy_blocks < 1024 ? copy_blocks : 1024, batch), threads, 0,
                               st>>>(a, l, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return chol_multi_cta::factor_launches(l, flags, diag, batch, m, st);
}
