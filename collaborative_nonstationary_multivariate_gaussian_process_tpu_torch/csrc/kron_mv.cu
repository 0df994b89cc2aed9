// Kronecker matvec (B kron K) y = vec((K Y B^T)^T) for Hopper (sm_90a), one
// per chain, without the (N1, M2) intermediate K Y in device memory.
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, kron_mv_pallas (body :216)
//   (in the port: the forward of ops/kron.kron_mv, and its input gradient).
//
//   out[c, i * N1 + r] = sum_j B[c, i, j] sum_n K[c, r, n] y[c, j * N2 + n]
//   K (C, N1, N2), B (C, M1, M2), y (C, M2 * N2) task-major; M1, M2 <= 16.
//
// Bound on the H100: bytes.  K is the only large operand (4 C N1 N2 bytes;
// 16 MB at C = 4, N = 1024) and is read once; the FMAs are 2 M2 per element
// of K, ~1 FLOP per byte at M = 2.
//
// Design: one warp per row of K (8 rows a block, blockIdx.y the chain).  The
// lanes stride the row (coalesced 128-byte reads) and keep the M2 partial
// products t[j] = sum_n K[r, n] Y[n, j] in registers; a butterfly reduction
// gives every lane the whole t, which is contracted with B^T at once, so
// the (N1, M2) product never leaves the SM.  y is read through the L1 cache
// by all the rows of a block.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 16;
constexpr int kWarps = 8;

__global__ void kron_mv_kernel(const float* __restrict__ K, const float* __restrict__ B,
                               const float* __restrict__ y, float* __restrict__ out, int n1,
                               int n2, int m1, int m2) {
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n1) return;
  const float* krow = K + ((size_t)c * n1 + row) * n2;
  const float* yc = y + (size_t)c * m2 * n2;

  float t[kMaxM];
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) t[j] = 0.0f;
  for (int n = lane; n < n2; n += 32) {
    const float k = krow[n];
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m2) t[j] = fmaf(k, yc[(size_t)j * n2 + n], t[j]);
  }
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) {
    if (j < m2) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t[j] += __shfl_xor_sync(0xffffffffu, t[j], off);
    }
  }
  if (lane < m1) {
    const float* brow = B + ((size_t)c * m1 + lane) * m2;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m2) acc = fmaf(brow[j], t[j], acc);
    out[((size_t)c * m1 + lane) * n1 + row] = acc;
  }
}

}  // namespace

// K (c, n1, n2), B (c, m1, m2), y (c, m2 * n2), out (c, m1 * n1); all
// float32, contiguous, on the stream's device; m1, m2 <= 16.  Returns
// cudaGetLastError().
extern "C" int kron_mv_launch(const float* K, const float* B, const float* y, float* out, int c,
                              int n1, int n2, int m1, int m2, void* stream) {
  if (m1 < 1 || m1 > kMaxM || m2 < 1 || m2 > kMaxM) return (int)cudaErrorInvalidValue;
  dim3 grid((n1 + kWarps - 1) / kWarps, c);
  kron_mv_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(K, B, y, out, n1, n2, m1, m2);
  return (int)cudaGetLastError();
}

extern "C" int kron_mv_max_m() { return kMaxM; }
