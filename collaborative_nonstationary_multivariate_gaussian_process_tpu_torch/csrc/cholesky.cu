// Batched lower Cholesky factor for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, cholesky_pallas -> _chol_forward -> _chol_kernel_body
//   (in the port: the forward of ops/linalg.cholesky, which serves the
//   jnp.linalg.cholesky sites of models/logdensities.py).
//
// Bound on the H100: latency, not bytes or FP32 rate.  A matrix costs M^3/6
// FMAs (M^3/3 flops) and (M (M + 1) / 2 + M^2) x 4 bytes (read K's lower
// triangle, write L): at M = 100 that is 0.17 MFMA and 60 KB, nanoseconds of
// HBM or FP32 time; the column recurrence is
// sequential, so the floor is M / NB block steps, each a chain of
// shared-memory sweeps and barriers on one SM per matrix.
//
// Design: one matrix per block (512 threads), the blocked right-looking
// factor of csrc/chol_blocked.cuh in place on the output: the matrix stays in
// global memory (L2-resident at these sizes) and the diagonal block and the
// panel go through shared memory.  NB = 32 where the panel of M rows fits the
// opt-in shared memory (M <= ~1700), else NB = 16 (M <= ~3400).
//
// Failure semantics follow jnp.linalg.cholesky as the port's cholesky_nan
// has them: a pivot that is <= 0 or not finite makes the member's lower
// triangle NaN; zeros above the diagonal in every member.
#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(chol_blocked::kThreads)
    cholesky_kernel(const float* __restrict__ a, float* l, int m) {
  extern __shared__ float smem[];
  const size_t base = (size_t)blockIdx.x * m * m;
  float* L = l + base;
  const int mm = m * m;
  for (int idx = threadIdx.x; idx < mm; idx += blockDim.x)
    L[idx] = (idx % m <= idx / m) ? a[base + idx] : 0.0f;
  __syncthreads();
  const bool ok = chol_blocked::factor<NB>(L, m, smem);
  __syncthreads();
  if (!ok) {
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = threadIdx.x; idx < mm; idx += blockDim.x)
      if (idx % m <= idx / m) L[idx] = nan;
  }
}

}  // namespace

// Largest m the kernel takes on the current device, or -1 if the device
// cannot be queried.
extern "C" int cholesky_max_m() { return chol_blocked::max_m(); }

// a, l: (batch, m, m) float32, contiguous; m <= cholesky_max_m().  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int cholesky_launch(const float* a, float* l, int batch, int m, void* stream) {
  return chol_blocked::launch(
      [](int nb) { return nb == 32 ? cholesky_kernel<32> : cholesky_kernel<16>; }, batch, m,
      (cudaStream_t)stream, a, l, m);
}
