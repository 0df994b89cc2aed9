// Gradient of the variance quadratic form with respect to A, for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, _qf_bwd_rule, the pallas_call at :667 (_qf_da_body
//   :553): the A half of the VJP of quadform_diag_pallas.
//
//   C[s, g]       = A[s]^T W[s, g]                         (N x M)
//   E[s, g, n, k] = 2 vbar[s, g, n] C[s, g, n, k]
//   dA[s, m, n]   = sum_g sum_{k <= m} W[s, g, m, k] E[s, g, n, k]
//   A (S, M, N), W (S, G, M, M) lower-triangular, vbar (S, G, N) -> dA (S, M, N),
//   all float32.  Only W's lower triangle is read, as in the forward.
//
// Bound on the H100: FP32 operations.  Per (g, n), M (M + 1) / 2 FMAs to
// recompute C over the triangle and M (M + 1) / 2 for W_g E_g^T.  At ECoG
// width (G = 3003 + 78 + 78 over the three calls of one step, M = 100,
// N = 512) that is 32.7 GFLOP, 0.49 ms at the 67 TFLOP/s non-tensor FP32
// rate, against ~64 MB of W's triangle read, 19 us at 3.35 TB/s.
//
// Design: the sum runs over G, so a block per N tile alone would give only
// N / 64 = 8 blocks at N = 512.  A block instead takes one (N tile of 64
// columns, chunk of groups, draw s): it stages its A tile once, then for each
// group of its chunk stages W_g's lower triangle (as rows, and transposed for
// the second product), recomputes the C tile in registers exactly as the
// forward does (4 columns n x 8 entries k per thread), scales it by
// 2 vbar[g, n] into E^T in shared memory, and adds W_g E_g^T into its
// register tile of dA (8 rows m x 4 columns n per thread, the row loop
// stopping at the diagonal).  Blocks of one chunk are adjacent in launch
// order, so the N tiles that share W_g read it from L2.  Each block writes
// its partial sum to a (S, chunks, M, N) buffer; a second kernel adds the
// chunks in a fixed order.  No atomics: the result is deterministic.  W is
// read in its (G, M, M) layout (the TPU kernel's flattened WT/WM operands
// and selector matmuls existed only for Mosaic).  Arithmetic is FP32 FMA, no
// tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 64;                   // columns n per tile
constexpr int kMicroN = 4;                   // columns n per thread (C and dA)
constexpr int kMicroK = 8;                   // C: entries k per thread; dA: rows m per thread
constexpr int kThreadsN = kTileN / kMicroN;  // threads along n
constexpr int kReduceThreads = 256;

__host__ __device__ inline int k_chunks(int m) { return (m + kMicroK - 1) / kMicroK; }

__global__ void quadform_diag_da_kernel(const float* __restrict__ A, const float* __restrict__ W,
                                        const float* __restrict__ vbar,
                                        float* __restrict__ partial, int m, int n, int g,
                                        int chunks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kc = k_chunks(m);
  const int mp = kc * kMicroK;
  float* Ws = smem;              // m x mp: W_g by rows, zero above the diagonal
  float* Wt = Ws + m * mp;       // m x mp: Wt[k, r] = W_g[r, k] for k <= r < m, else zero
  float* As = Wt + m * mp;       // m x kTileN: A tile, zero beyond column n
  float* Et = As + m * kTileN;   // mp x kTileN: E^T tile

  const int n0 = blockIdx.x * kTileN;
  const int chunk = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // kThreadsN * kc
  const int tn = tid % kThreadsN;
  const int tk = tid / kThreadsN;   // k-block of C; row block of dA
  const int per_chunk = (g + chunks - 1) / chunks;
  const int g_lo = chunk * per_chunk;
  const int g_hi = g_lo + per_chunk < g ? g_lo + per_chunk : g;
  const float* Ab = A + (size_t)s * m * n;

  for (int i = tid; i < m * kTileN; i += nthreads) {
    const int r = i / kTileN;
    const int c = n0 + i % kTileN;
    As[i] = c < n ? Ab[(size_t)r * n + c] : 0.0f;
  }

  float dacc[kMicroK][kMicroN];
#pragma unroll
  for (int i = 0; i < kMicroK; ++i)
#pragma unroll
    for (int j = 0; j < kMicroN; ++j) dacc[i][j] = 0.0f;
  const int m0 = tk * kMicroK;
  const int k_end = m0 + kMicroK < m ? m0 + kMicroK : m;  // W[r, k] = 0 for k > r

  for (int gi = g_lo; gi < g_hi; ++gi) {
    const float* Wg = W + ((size_t)s * g + gi) * m * m;
    const float* vg = vbar + ((size_t)s * g + gi) * n;
    __syncthreads();  // previous group's Ws, Wt and Et consumed
    for (int i = tid; i < m * mp; i += nthreads) {
      const int r = i / mp;
      const int c = i % mp;
      Ws[i] = c <= r ? Wg[r * m + c] : 0.0f;  // lower triangle; c <= r < m
    }
    __syncthreads();
    for (int i = tid; i < m * mp; i += nthreads) {
      const int k = i / mp;
      const int r = i % mp;
      Wt[i] = r < m ? Ws[r * mp + k] : 0.0f;
    }

    float acc[kMicroN][kMicroK];
#pragma unroll
    for (int i = 0; i < kMicroN; ++i)
#pragma unroll
      for (int j = 0; j < kMicroK; ++j) acc[i][j] = 0.0f;
    const float* a_col = As + tn * kMicroN;
    const float* w_col = Ws + tk * kMicroK;
#pragma unroll 4
    for (int r = tk * kMicroK; r < m; ++r) {  // W[r, k] = 0 for r < k
      const float4 a = *reinterpret_cast<const float4*>(a_col + r * kTileN);
      const float4 w0 = *reinterpret_cast<const float4*>(w_col + r * mp);
      const float4 w1 = *reinterpret_cast<const float4*>(w_col + r * mp + 4);
      const float av[kMicroN] = {a.x, a.y, a.z, a.w};
      const float wv[kMicroK] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < kMicroN; ++i)
#pragma unroll
        for (int j = 0; j < kMicroK; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    float sc[kMicroN];
#pragma unroll
    for (int i = 0; i < kMicroN; ++i) {
      const int col = n0 + tn * kMicroN + i;
      sc[i] = col < n ? 2.0f * vg[col] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMicroK; ++j)
      *reinterpret_cast<float4*>(Et + (tk * kMicroK + j) * kTileN + tn * kMicroN) =
          make_float4(sc[0] * acc[0][j], sc[1] * acc[1][j], sc[2] * acc[2][j], sc[3] * acc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < k_end; ++k) {
      const float4 w0 = *reinterpret_cast<const float4*>(Wt + k * mp + m0);
      const float4 w1 = *reinterpret_cast<const float4*>(Wt + k * mp + m0 + 4);
      const float4 e = *reinterpret_cast<const float4*>(Et + k * kTileN + tn * kMicroN);
      const float wv[kMicroK] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float ev[kMicroN] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < kMicroK; ++i)
#pragma unroll
        for (int j = 0; j < kMicroN; ++j) dacc[i][j] = fmaf(wv[i], ev[j], dacc[i][j]);
    }
  }

  float* P = partial + ((size_t)s * chunks + chunk) * m * n;
#pragma unroll
  for (int i = 0; i < kMicroK; ++i) {
    const int r = m0 + i;
#pragma unroll
    for (int j = 0; j < kMicroN; ++j) {
      const int col = n0 + tn * kMicroN + j;
      if (r < m && col < n) P[(size_t)r * n + col] = dacc[i][j];
    }
  }
}

// dA[s, i] = sum over c = 0, 1, ... of partial[s, c, i], in that order.
__global__ void quadform_diag_da_reduce(const float* __restrict__ partial, float* __restrict__ dA,
                                        int chunks, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (i >= mn) return;
  const float* p = partial + (size_t)s * chunks * mn + i;
  float v = 0.0f;
  for (int c = 0; c < chunks; ++c) v += p[(size_t)c * mn];
  dA[(size_t)s * mn + i] = v;
}

// Dynamic shared memory one block needs for inducing size m: W_g in both
// layouts, the A tile and the E^T tile.
size_t smem_bytes(int m) {
  const int mp = k_chunks(m) * kMicroK;
  return (2 * (size_t)m * mp + (size_t)m * kTileN + (size_t)mp * kTileN) * sizeof(float);
}

}  // namespace

// Largest inducing size m whose block fits the current device's opt-in shared
// memory and thread limit, or -1 if the device cannot be queried.
extern "C" int quadform_diag_da_max_m() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, quadform_diag_da_kernel) != cudaSuccess)
    return -1;
  int m = 0;
  while (smem_bytes(m + 1) + attr.sharedSizeBytes <= (size_t)optin &&
         kThreadsN * k_chunks(m + 1) <= attr.maxThreadsPerBlock)
    ++m;
  return m;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n), partial
// (s, chunks, m, n) scratch, dA (s, m, n): float32, contiguous;
// m <= quadform_diag_da_max_m(), 1 <= chunks <= g.  Returns
// cudaGetLastError() after both launches (or the first error).
extern "C" int quadform_diag_da_launch(const float* A, const float* W, const float* vbar,
                                       float* partial, float* dA, int s, int g, int m, int n,
                                       int chunks, void* stream) {
  if (chunks < 1 || chunks > g) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(quadform_diag_da_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + kTileN - 1) / kTileN, chunks, s);
  quadform_diag_da_kernel<<<grid, kThreadsN * k_chunks(m), smem, st>>>(A, W, vbar, partial, m, n,
                                                                        g, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mn = m * n;
  dim3 rgrid((mn + kReduceThreads - 1) / kReduceThreads, s);
  quadform_diag_da_reduce<<<rgrid, kReduceThreads, 0, st>>>(partial, dA, chunks, mn);
  return (int)cudaGetLastError();
}
