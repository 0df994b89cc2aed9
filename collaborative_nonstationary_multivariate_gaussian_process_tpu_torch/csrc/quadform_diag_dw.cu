// Gradient of the variance quadratic form with respect to W, for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, _qf_bwd_rule, the pallas_call at :648 (_qf_dwt_body
//   :529): the W half of the VJP of quadform_diag_pallas.
//
//   C[s, g]        = A[s]^T W[s, g]                        (N x M)
//   E[s, g, n, k]  = 2 vbar[s, g, n] C[s, g, n, k]
//   dW[s, g, m, k] = sum_n A[s, m, n] E[s, g, n, k]        for k <= m, 0 above
//   A (S, M, N), W (S, G, M, M) lower-triangular, vbar (S, G, N) -> dW (S, G, M, M),
//   all float32.
//
// Lower triangle only.  On the path W = Lp^-1 @ tril(sqrt) is lower-triangular
// (the forward kernel reads only that triangle), and the strictly-upper part
// of dW reaches no parameter: through the matmul's backward it becomes
// strictly-upper cotangents of Lp^-1 and of tril(sqrt), which the Cholesky-
// inverse backward (tril(L^T Lbar)) and the tril masks drop.  So this kernel
// computes the lower triangle, half the product, and writes zeros above it.
//
// Bound on the H100: FP32 operations.  Per (g, n), M (M + 1) / 2 FMAs to
// recompute C over the triangle and M (M + 1) / 2 for dW's triangle.  At ECoG
// width (G = 3003 + 78 + 78 over the three calls of one step, M = 100,
// N = 512) that is 32.7 GFLOP, 0.49 ms at the 67 TFLOP/s non-tensor FP32
// rate, against ~64 MB of W's triangle read and 126 MB of dW written, 57 us
// at 3.35 TB/s.  The library route (two einsums and a product) writes and
// reads the (G, N, M) intermediates C and E, ~650 MB each.
//
// Design: one block per (group g, draw s); nothing crosses blocks, so there
// are no atomics and the result is deterministic.  W_g's lower triangle is
// staged once in shared memory (M x M, 40 KB at M = 100).  Then per N tile of
// 64 columns: the A tile is staged twice, as (M, 64) for the C product and as
// (64, M) for the dW product; C = A^T W_g is recomputed in registers exactly
// as the forward does (a thread owns 4 columns n x 8 entries k and starts its
// row loop at its own k-block), scaled by 2 vbar[g, n] into E in shared
// memory; then each thread adds sum_n A[m, n] E[n, k] into its register tile
// of dW (4 rows m x 8 entries k).  Only the 8-wide k-blocks that meet the
// lower triangle are owned, 169 tiles at M = 100.  dW leaves registers once,
// at the end.  W is read in its (G, M, M) layout: the TPU kernel's flattened
// WT operand and 0/1 selector matmuls existed only because Mosaic could not
// relayout inside a kernel.  Arithmetic is FP32 FMA, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 64;                    // columns n per tile
constexpr int kMicroN = 4;                    // C: columns n per thread
constexpr int kMicroK = 8;                    // C and dW: entries k per thread
constexpr int kMicroM = 4;                    // dW: rows m per thread
constexpr int kThreadsN = kTileN / kMicroN;   // threads along n in the C product

__host__ __device__ inline int k_chunks(int m) { return (m + kMicroK - 1) / kMicroK; }
__host__ __device__ inline int m_chunks(int m) { return (m + kMicroM - 1) / kMicroM; }

// k-blocks of dW row block mb (rows 4 mb .. 4 mb + 3) that meet the lower triangle.
__host__ __device__ inline int row_k_blocks(int mb, int kc) {
  const int last = (kMicroM * mb + kMicroM - 1) / kMicroK;
  return last + 1 < kc ? last + 1 : kc;
}

__host__ __device__ inline int lower_tiles(int m) {
  int t = 0;
  for (int mb = 0; mb < m_chunks(m); ++mb) t += row_k_blocks(mb, k_chunks(m));
  return t;
}

int block_threads(int m) {
  const int c = kThreadsN * k_chunks(m);
  const int w = lower_tiles(m);
  return c > w ? c : w;
}

__global__ void quadform_diag_dw_kernel(const float* __restrict__ A, const float* __restrict__ W,
                                        const float* __restrict__ vbar, float* __restrict__ dW,
                                        int m, int n, int g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kc = k_chunks(m);
  const int mp = kc * kMicroK;
  float* Ws = smem;              // m x mp: W_g, zero above the diagonal and beyond column m
  float* As = Ws + m * mp;       // m x kTileN: A tile, zero beyond column n
  float* At = As + m * kTileN;   // kTileN x mp: the same tile transposed, zero beyond m
  float* Es = At + kTileN * mp;  // kTileN x mp: E tile

  const int gi = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* Wg = W + ((size_t)s * g + gi) * m * m;
  const float* Ab = A + (size_t)s * m * n;
  const float* vg = vbar + ((size_t)s * g + gi) * n;
  float* dWg = dW + ((size_t)s * g + gi) * m * m;

  // C role: 4 columns n x 8 entries k of the C tile
  const int tn = tid % kThreadsN;
  const int tk = tid / kThreadsN;
  const bool c_role = tk < kc;
  // dW role: one 4 x 8 tile of dW's lower triangle, (row block mb, k-block kb)
  int mb = -1, kb = 0;
  for (int b = 0, t = tid; b < m_chunks(m); ++b) {
    const int cnt = row_k_blocks(b, kc);
    if (t < cnt) {
      mb = b;
      kb = t;
      break;
    }
    t -= cnt;
  }
  const bool w_role = mb >= 0;
  const int m0 = mb * kMicroM;
  const int k0 = kb * kMicroK;

  for (int i = tid; i < m * mp; i += nthreads) {
    const int r = i / mp;
    const int c = i % mp;
    Ws[i] = c <= r ? Wg[r * m + c] : 0.0f;  // lower triangle; c <= r < m
  }
  for (int i = tid; i < kTileN * mp; i += nthreads) At[i] = 0.0f;  // columns >= m stay zero

  float dacc[kMicroM][kMicroK];
#pragma unroll
  for (int i = 0; i < kMicroM; ++i)
#pragma unroll
    for (int j = 0; j < kMicroK; ++j) dacc[i][j] = 0.0f;

  for (int n0 = 0; n0 < n; n0 += kTileN) {
    __syncthreads();  // W staged (first tile) / previous tile's As, At and Es consumed
    for (int i = tid; i < m * kTileN; i += nthreads) {
      const int r = i / kTileN;
      const int c = i % kTileN;
      const float a = n0 + c < n ? Ab[(size_t)r * n + n0 + c] : 0.0f;
      As[i] = a;
      At[c * mp + r] = a;
    }
    __syncthreads();

    if (c_role) {
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
#pragma unroll
      for (int i = 0; i < kMicroN; ++i) {
        const int col = n0 + tn * kMicroN + i;
        const float sc = col < n ? 2.0f * vg[col] : 0.0f;
        float4* e = reinterpret_cast<float4*>(Es + (tn * kMicroN + i) * mp + tk * kMicroK);
        e[0] = make_float4(sc * acc[i][0], sc * acc[i][1], sc * acc[i][2], sc * acc[i][3]);
        e[1] = make_float4(sc * acc[i][4], sc * acc[i][5], sc * acc[i][6], sc * acc[i][7]);
      }
    }
    __syncthreads();

    if (w_role) {
      const int cols = n - n0 < kTileN ? n - n0 : kTileN;
#pragma unroll 4
      for (int c = 0; c < cols; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(At + c * mp + m0);
        const float4 e0 = *reinterpret_cast<const float4*>(Es + c * mp + k0);
        const float4 e1 = *reinterpret_cast<const float4*>(Es + c * mp + k0 + 4);
        const float av[kMicroM] = {a.x, a.y, a.z, a.w};
        const float ev[kMicroK] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < kMicroM; ++i)
#pragma unroll
          for (int j = 0; j < kMicroK; ++j) dacc[i][j] = fmaf(av[i], ev[j], dacc[i][j]);
      }
    }
  }

  if (w_role) {
#pragma unroll
    for (int i = 0; i < kMicroM; ++i) {
      const int r = m0 + i;
#pragma unroll
      for (int j = 0; j < kMicroK; ++j) {
        const int k = k0 + j;
        if (r < m && k <= r) dWg[r * m + k] = dacc[i][j];
      }
    }
  }
  for (int i = tid; i < m * m; i += nthreads) {
    if (i % m > i / m) dWg[i] = 0.0f;  // above the diagonal
  }
}

// Dynamic shared memory one block needs for inducing size m: W_g, the A tile
// in both layouts and the E tile.
size_t smem_bytes(int m) {
  const int mp = k_chunks(m) * kMicroK;
  return ((size_t)m * mp + (size_t)m * kTileN + 2 * (size_t)kTileN * mp) * sizeof(float);
}

}  // namespace

// Largest inducing size m whose block fits the current device's opt-in shared
// memory and thread limit, or -1 if the device cannot be queried.
extern "C" int quadform_diag_dw_max_m() {
  int dev = 0, optin = 0, max_threads = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, quadform_diag_dw_kernel) != cudaSuccess)
    return -1;
  max_threads = attr.maxThreadsPerBlock;
  int m = 0;
  while (smem_bytes(m + 1) + attr.sharedSizeBytes <= (size_t)optin &&
         block_threads(m + 1) <= max_threads)
    ++m;
  return m;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n), dW (s, g, m, m):
// float32, contiguous; m <= quadform_diag_dw_max_m().  Returns
// cudaGetLastError() (or the error of the opt-in).
extern "C" int quadform_diag_dw_launch(const float* A, const float* W, const float* vbar,
                                       float* dW, int s, int g, int m, int n, void* stream) {
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(quadform_diag_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g, s);
  quadform_diag_dw_kernel<<<grid, block_threads(m), smem, (cudaStream_t)stream>>>(A, W, vbar, dW,
                                                                                  m, n, g);
  return (int)cudaGetLastError();
}
