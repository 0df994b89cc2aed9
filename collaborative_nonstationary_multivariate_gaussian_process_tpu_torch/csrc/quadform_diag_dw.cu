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
// width (G = 3003, M = 100, N = 512) that is 15.5 GFLOP, 0.23 ms at the
// 67 TFLOP/s non-tensor FP32 rate, against ~60 MB of W's triangle read and
// 120 MB of dW written, 54 us at 3.35 TB/s.  The library route (two einsums)
// writes and reads the (G, N, M) intermediates C and E.
//
// Design: k-panels.  Column k of dW needs only column k of C, and both
// products of a panel of KP = 32 columns [k0, k0 + 32) read the same slab,
// W_g[k0:M, k0:k0+32] (W is lower-triangular), and rows k0:M of A.  So a
// block takes one (group g, panel, draw s): shared memory holds the slab
// (M x 32) and an A tile (M x TN columns n), O(M KP) and not O(M^2), which
// takes M up to ~700 (the limit is `quadform_diag_dw_max_m`).  TN is 64
// where that block fits the opt-in shared memory and 512 threads (M up to
// ~440), else 32.  Panels of dW are independent: no reduction crosses
// blocks, no atomics, and the result is deterministic.  Per N tile:
//   (a) C[n, panel] = sum_{m >= k0} A[m, n] W[m, panel]: TN owners of a
//       4 (n) x 8 (k) register tile, the rows split into one contiguous chunk
//       per owner group; each group's partial tile goes to shared memory and
//       the chunks are added in a fixed order, scaled by 2 vbar[g, n] into E;
//   (b) each thread adds sum_n A[m, n] E[n, k] into its 8 (m) x 8 (k)
//       register tile of the panel's dW (rows k0:M).
// dW leaves registers once, at the end.  The thread count follows M (one
// 8 x 8 tile per thread for panel 0, at most 512).  A and the slab are
// staged with 16-byte loads where N (and M) are multiples of 4.  W is read in its
// (G, M, M) layout: the TPU kernel's flattened WT operand and 0/1 selector
// matmuls existed only because Mosaic could not relayout inside a kernel.
// Arithmetic is FP32 FMA, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kKP = 32;            // columns k per panel
constexpr int kMaxThreads = 512;

__host__ __device__ inline int panels(int m) { return (m + kKP - 1) / kKP; }
__host__ __device__ inline int m_blocks(int m) { return (m + 7) / 8; }

// Threads of a block: one 8 x 8 dW tile each for panel 0 (4 k-blocks x
// ceil(M / 8) row blocks), a multiple of TN (the owners of the C tile).
__host__ __device__ inline int block_threads(int m, int tn) {
  const int t = (4 * m_blocks(m) + tn - 1) / tn * tn;
  return t < tn ? tn : t;
}

// Dynamic shared memory one block needs for inducing size m: the slab of
// panel 0, the E tile, the partial C tiles and the A tile (rows padded to
// the 8-row tiles of (b)).
size_t smem_bytes(int m, int tn) {
  const size_t groups = block_threads(m, tn) / tn;
  return ((size_t)m * kKP + (size_t)tn * kKP * (1 + groups) + (size_t)8 * m_blocks(m) * (tn + 1)) *
         sizeof(float);
}

// The slab W[k0 + r, k0 + kk] (kk <= r) of panel k0 into Ws (rows x kKP),
// zero above the diagonal and beyond column m.
__device__ inline void stage_slab(float* Ws, const float* Wg, int m, int k0, int rows) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (m % 4 == 0) {
    for (int i = tid; i < rows * kKP / 4; i += nthreads) {
      const int r = i / (kKP / 4), kk = 4 * (i % (kKP / 4));
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kk <= r && k0 + kk < m) w = *reinterpret_cast<const float4*>(Wg + (size_t)(k0 + r) * m + k0 + kk);
      Ws[r * kKP + kk] = w.x;
      Ws[r * kKP + kk + 1] = kk + 1 <= r ? w.y : 0.0f;
      Ws[r * kKP + kk + 2] = kk + 2 <= r ? w.z : 0.0f;
      Ws[r * kKP + kk + 3] = kk + 3 <= r ? w.w : 0.0f;
    }
  } else {
    for (int i = tid; i < rows * kKP; i += nthreads) {
      const int r = i / kKP, kk = i % kKP;
      Ws[i] = (kk <= r && k0 + kk < m) ? Wg[(size_t)(k0 + r) * m + k0 + kk] : 0.0f;
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(kMaxThreads)
    quadform_diag_dw_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ vbar, float* __restrict__ dW, int m, int n,
                            int g) {
  constexpr int kLdA = TN + 1;  // row stride of the A tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nthreads = blockDim.x;
  const int groups = nthreads / TN;
  float* Ws = smem;                   // m x kKP: the slab W[k0 + r, k0 + kk], zero above the diagonal
  float* Es = Ws + m * kKP;           // TN x kKP: the E tile
  float* Cb = Es + TN * kKP;          // groups x TN x kKP: partial C tiles
  float* As = Cb + groups * TN * kKP;  // 8 m_blocks(m) x kLdA: rows k0.. of the A tile

  const int gi = blockIdx.x;
  const int k0 = blockIdx.y * kKP;
  const int s = blockIdx.z;
  const int rows = m - k0;            // slab rows: m = k0 + r
  const int arows = 8 * m_blocks(rows);
  const int tid = threadIdx.x;
  const float* Wg = W + ((size_t)s * g + gi) * m * m;
  const float* Ab = A + (size_t)s * m * n;
  const float* vg = vbar + ((size_t)s * g + gi) * n;
  float* dWg = dW + ((size_t)s * g + gi) * m * m;

  // (a) role: owner o (4 columns n x 8 entries k) of group q's row chunk
  const int o = tid % TN, q = tid / TN;
  const int tn = o % (TN / 4), tk = o / (TN / 4);
  const int chunk = (rows + groups - 1) / groups;
  const int r_lo = max(q * chunk, tk * 8);  // W[k0 + r, k0 + k] = 0 for r < k
  const int r_hi = min(rows, (q + 1) * chunk);
  // (b) role: the 8 x 8 dW tile (rows 8 mb.., entries 8 kb..) of the slab
  const int kb = tid % 4, mb = tid / 4;
  const bool w_role = mb < m_blocks(rows) && 8 * mb + 7 >= 8 * kb;  // meets the triangle

  stage_slab(Ws, Wg, m, k0, rows);

  float dacc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.0f;

  for (int n0 = 0; n0 < n; n0 += TN) {
    __syncthreads();  // slab staged (first tile) / previous tile's As and Es consumed
    if (n % 4 == 0) {  // rows k0.. of A, zero beyond row m and column n
      for (int i = tid; i < arows * TN / 4; i += nthreads) {
        const int r = i / (TN / 4), c = 4 * (i % (TN / 4));
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows && n0 + c < n) a = *reinterpret_cast<const float4*>(Ab + (size_t)(k0 + r) * n + n0 + c);
        float* d = As + r * kLdA + c;
        d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
      }
    } else {
      for (int i = tid; i < arows * TN; i += nthreads) {
        const int r = i / TN, c = i % TN;
        As[r * kLdA + c] = r < rows && n0 + c < n ? Ab[(size_t)(k0 + r) * n + n0 + c] : 0.0f;
      }
    }
    __syncthreads();

    {  // (a) this group's chunk of C
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      const float* a_col = As + tn * 4;
      const float* w_col = Ws + tk * 8;
#pragma unroll 2
      for (int r = r_lo; r < r_hi; ++r) {
        const float av[4] = {a_col[r * kLdA], a_col[r * kLdA + 1], a_col[r * kLdA + 2],
                             a_col[r * kLdA + 3]};
        const float4 w0 = *reinterpret_cast<const float4*>(w_col + r * kKP);
        const float4 w1 = *reinterpret_cast<const float4*>(w_col + r * kKP + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      float* cb = Cb + q * TN * kKP;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* e = reinterpret_cast<float4*>(cb + (tn * 4 + i) * kKP + tk * 8);
        e[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        e[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    __syncthreads();
    // the chunks added in a fixed order, scaled into E
    for (int e = tid; e < TN * kKP; e += nthreads) {
      const int c = n0 + e / kKP;
      float v = 0.0f;
      for (int p = 0; p < groups; ++p) v += Cb[p * TN * kKP + e];
      Es[e] = c < n ? 2.0f * vg[c] * v : 0.0f;
    }
    __syncthreads();

    if (w_role) {  // (b)
      const int cols = min(TN, n - n0);
      const float* a_row = As + 8 * mb * kLdA;
#pragma unroll 2
      for (int c = 0; c < cols; ++c) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = a_row[i * kLdA + c];
        const float4 e0 = *reinterpret_cast<const float4*>(Es + c * kKP + kb * 8);
        const float4 e1 = *reinterpret_cast<const float4*>(Es + c * kKP + kb * 8 + 4);
        const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dacc[i][j] = fmaf(av[i], ev[j], dacc[i][j]);
      }
    }
  }

  if (w_role) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * mb + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * kb + j;
        if (r < rows && k0 + kk < m && kk <= r) dWg[(size_t)(k0 + r) * m + k0 + kk] = dacc[i][j];
      }
    }
  }
  // zeros above the diagonal in this panel's columns
  const int zrows = min(m, k0 + kKP);
  for (int i = tid; i < zrows * kKP; i += nthreads) {
    const int r = i / kKP, k = k0 + i % kKP;
    if (k < m && k > r) dWg[(size_t)r * m + k] = 0.0f;
  }
}

// Whether the TN-wide kernel takes inducing size m on the current device.
template <int TN>
bool fits(int m, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, quadform_diag_dw_kernel<TN>) != cudaSuccess) return false;
  return smem_bytes(m, TN) + attr.sharedSizeBytes <= (size_t)optin &&
         block_threads(m, TN) <= attr.maxThreadsPerBlock;
}

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

template <int TN>
int launch(const float* A, const float* W, const float* vbar, float* dW, int s, int g, int m, int n,
           cudaStream_t st) {
  const size_t smem = smem_bytes(m, TN);
  cudaError_t err = cudaFuncSetAttribute(quadform_diag_dw_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  quadform_diag_dw_kernel<TN><<<dim3(g, panels(m), s), block_threads(m, TN), smem, st>>>(A, W, vbar,
                                                                                     dW, m, n, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest inducing size m whose block fits the current device's opt-in shared
// memory and thread limit (with TN = 32), or -1 if the device cannot be queried.
extern "C" int quadform_diag_dw_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits<32>(m + 1, optin)) ++m;
  return m;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n), dW (s, g, m, m):
// float32, contiguous; m <= quadform_diag_dw_max_m().  Returns
// cudaGetLastError() (or the error of the opt-in).
extern "C" int quadform_diag_dw_launch(const float* A, const float* W, const float* vbar,
                                       float* dW, int s, int g, int m, int n, void* stream) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = (cudaStream_t)stream;
  if (fits<64>(m, optin)) return launch<64>(A, W, vbar, dW, s, g, m, n, st);
  if (fits<32>(m, optin)) return launch<32>(A, W, vbar, dW, s, g, m, n, st);
  return (int)cudaErrorInvalidValue;
}
