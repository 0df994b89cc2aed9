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
// width (G = 3003, M = 100, N = 512) that is 15.5 GFLOP, 0.23 ms at the
// 67 TFLOP/s non-tensor FP32 rate, against ~60 MB of W's triangle read,
// 18 us at 3.35 TB/s.
//
// Design: the sum runs over G, so a block per N tile alone would give only
// N / TN = 8 blocks at N = 512.  A block instead takes one (N tile of TN
// columns, chunk of groups, draw s) and keeps its dA tile (M x TN) in
// registers, one 8 (m) x 8 (n) tile per thread; TN is 64 where that block
// fits the opt-in shared memory and 512 threads (M up to ~400), else 32.
// It stages its A tile once,
// then for each group of its chunk walks W_g in k-panels of KP = 32 columns
// [k0, k0 + 32): both products of a panel read the same slab W_g[k0:M,
// k0:k0+32] (W is lower-triangular), so shared memory is O(M KP) and not
// O(M^2), which takes M up to ~700 (`quadform_diag_da_max_m`).  Per panel:
//   (a) C[n, panel] = sum_{m >= k0} A[m, n] W[m, panel]: TN owners of a
//       4 (n) x 8 (k) register tile, the rows split into one contiguous chunk
//       per owner group; the partial tiles are added in a fixed order and scaled by
//       2 vbar[g, n] into E^T in shared memory;
//   (b) each thread adds sum_{k in panel, k <= m} W[m, k] E[n, k] into its
//       register tile (rows m >= k0 only: W[m, k] = 0 for k > m).
// Blocks of one chunk are adjacent in launch order, so the N tiles that share
// W_g read it from L2.  Each block writes its partial sum to a (S, chunks, M,
// N) buffer (the chunk count, `quadform_diag_da_chunks`, gives six blocks per
// SM); a second kernel adds the chunks in a fixed order.  No atomics:
// the result is deterministic.  W is read in its (G, M, M) layout (the TPU
// kernel's flattened WT/WM operands and selector matmuls existed only for
// Mosaic).  Arithmetic is FP32 FMA, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kKP = 32;            // columns k per panel
constexpr int kLdW = kKP + 1;      // row stride of the slab
constexpr int kMaxThreads = 512;
constexpr int kReduceThreads = 256;

__host__ __device__ inline int m_blocks(int m) { return (m + 7) / 8; }

// Threads of a block: one 8 x 8 dA tile each (TN / 8 n-blocks x ceil(M / 8)
// row blocks), a multiple of TN (the owners of the C tile).
__host__ __device__ inline int block_threads(int m, int tn) {
  const int t = ((tn / 8) * m_blocks(m) + tn - 1) / tn * tn;
  return t < tn ? tn : t;
}

// Dynamic shared memory one block needs for inducing size m: the A tile,
// E^T, the partial C tiles and the slab of panel 0.
size_t smem_bytes(int m, int tn) {
  const size_t groups = block_threads(m, tn) / tn;
  return ((size_t)m * tn + (size_t)kKP * tn * (1 + groups) + (size_t)8 * m_blocks(m) * kLdW) *
         sizeof(float);
}

template <int TN>
__global__ void __launch_bounds__(kMaxThreads)
    quadform_diag_da_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ vbar, float* __restrict__ partial, int m,
                            int n, int g, int chunks) {
  constexpr int NB = TN / 8;            // n-blocks of 8 columns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nthreads = blockDim.x;
  const int groups = nthreads / TN;
  const int mpad = 8 * m_blocks(m);
  float* As = smem;                     // m x TN: the A tile, zero beyond column n
  float* Et = As + m * TN;              // kKP x TN: E^T of the panel
  float* Cb = Et + kKP * TN;            // groups x TN x kKP: partial C tiles
  float* Ws = Cb + groups * TN * kKP;   // mpad x kLdW: the slab W[k0 + r, k0 + kk]

  const int n0 = blockIdx.x * TN;
  const int chunk = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int per_chunk = (g + chunks - 1) / chunks;
  const int g_lo = chunk * per_chunk;
  const int g_hi = min(g, g_lo + per_chunk);
  const float* Ab = A + (size_t)s * m * n;

  if (n % 4 == 0) {
    for (int i = tid; i < m * TN / 4; i += nthreads) {
      const int r = i / (TN / 4), c = 4 * (i % (TN / 4));
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n0 + c < n) a = *reinterpret_cast<const float4*>(Ab + (size_t)r * n + n0 + c);
      *reinterpret_cast<float4*>(As + r * TN + c) = a;
    }
  } else {
    for (int i = tid; i < m * TN; i += nthreads) {
      const int r = i / TN, c = n0 + i % TN;
      As[i] = c < n ? Ab[(size_t)r * n + c] : 0.0f;
    }
  }

  // (a) role: owner o (4 columns n x 8 entries k) of group q's row chunk
  const int o = tid % TN, q = tid / TN;
  const int tn = o % (TN / 4), tk = o / (TN / 4);
  // (b) role: rows 8 mb.. x columns 8 nb.. of the dA tile
  const int nb = tid % NB, mb = tid / NB;
  const int m0 = 8 * mb;

  float dacc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.0f;

  for (int gi = g_lo; gi < g_hi; ++gi) {
    const float* Wg = W + ((size_t)s * g + gi) * m * m;
    const float* vg = vbar + ((size_t)s * g + gi) * n;
    for (int k0 = 0; k0 < m; k0 += kKP) {
      const int rows = m - k0;
      __syncthreads();  // the previous panel's slab and E^T consumed (A staged, first time)
      if (m % 4 == 0) {
        for (int i = tid; i < (mpad - k0) * kKP / 4; i += nthreads) {
          const int r = i / (kKP / 4), kk = 4 * (i % (kKP / 4));
          float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (r < rows && kk <= r && k0 + kk < m)
            w = *reinterpret_cast<const float4*>(Wg + (size_t)(k0 + r) * m + k0 + kk);
          float* d = Ws + r * kLdW + kk;
          d[0] = w.x, d[1] = kk + 1 <= r ? w.y : 0.0f, d[2] = kk + 2 <= r ? w.z : 0.0f,
          d[3] = kk + 3 <= r ? w.w : 0.0f;
        }
      } else {
        for (int i = tid; i < (mpad - k0) * kKP; i += nthreads) {
          const int r = i / kKP, kk = i % kKP;
          Ws[r * kLdW + kk] =
              (r < rows && kk <= r && k0 + kk < m) ? Wg[(size_t)(k0 + r) * m + k0 + kk] : 0.0f;
        }
      }
      __syncthreads();

      {  // (a) this group's chunk of C
        const int span = (rows + groups - 1) / groups;
        const int r_lo = max(q * span, tk * 8);  // W[k0 + r, k0 + k] = 0 for r < k
        const int r_hi = min(rows, (q + 1) * span);
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        const float* a_col = As + k0 * TN + tn * 4;
        const float* w_col = Ws + tk * 8;
#pragma unroll 2
        for (int r = r_lo; r < r_hi; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(a_col + r * TN);
          const float av[4] = {a.x, a.y, a.z, a.w};
          float wv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) wv[j] = w_col[r * kLdW + j];
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
      // the chunks added in a fixed order, scaled into E^T
      for (int e = tid; e < TN * kKP; e += nthreads) {
        const int c = e / kKP, kk = e % kKP;
        float v = 0.0f;
        for (int p = 0; p < groups; ++p) v += Cb[p * TN * kKP + e];
        Et[kk * TN + c] = n0 + c < n ? 2.0f * vg[n0 + c] * v : 0.0f;
      }
      __syncthreads();

      if (m0 >= k0 && m0 < m) {  // (b); rows above k0 meet only zeros of W
        const int kk_end = min(kKP, min(m0 + 8 - k0, rows));
        const float* w_row = Ws + (m0 - k0) * kLdW;
        const float* e_col = Et + nb * 8;
#pragma unroll 2
        for (int kk = 0; kk < kk_end; ++kk) {
          float wv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[i] = w_row[i * kLdW + kk];
          const float4 e0 = *reinterpret_cast<const float4*>(e_col + kk * TN);
          const float4 e1 = *reinterpret_cast<const float4*>(e_col + kk * TN + 4);
          const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dacc[i][j] = fmaf(wv[i], ev[j], dacc[i][j]);
        }
      }
    }
  }

  if (m0 < m) {
    float* P = partial + ((size_t)s * chunks + chunk) * m * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + nb * 8 + j;
        if (r < m && col < n) P[(size_t)r * n + col] = dacc[i][j];
      }
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

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Whether the TN-wide kernel takes inducing size m on the current device.
template <int TN>
bool fits(int m, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, quadform_diag_da_kernel<TN>) != cudaSuccess) return false;
  return smem_bytes(m, TN) + attr.sharedSizeBytes <= (size_t)optin &&
         block_threads(m, TN) <= attr.maxThreadsPerBlock;
}

// The N tile the launch takes for inducing size m: 64 where it fits, else 32.
int tile_n(int m) { return fits<64>(m, optin_bytes()) ? 64 : 32; }

template <int TN>
int launch(const float* A, const float* W, const float* vbar, float* partial, float* dA, int s,
           int g, int m, int n, int chunks, cudaStream_t st) {
  const size_t smem = smem_bytes(m, TN);
  cudaError_t err = cudaFuncSetAttribute(quadform_diag_da_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TN - 1) / TN, chunks, s);
  quadform_diag_da_kernel<TN><<<grid, block_threads(m, TN), smem, st>>>(A, W, vbar, partial, m, n,
                                                                         g, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mn = m * n;
  dim3 rgrid((mn + kReduceThreads - 1) / kReduceThreads, s);
  quadform_diag_da_reduce<<<rgrid, kReduceThreads, 0, st>>>(partial, dA, chunks, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest inducing size m whose block fits the current device's opt-in shared
// memory and thread limit (with TN = 32), or -1 if the device cannot be queried.
extern "C" int quadform_diag_da_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits<32>(m + 1, optin)) ++m;
  return m;
}

// Chunks of groups for (s, g, m, n): enough (N tile, chunk) blocks for six per
// streaming multiprocessor, at most one chunk per group; -1 if the device
// cannot be queried.
extern "C" int quadform_diag_da_chunks(int s, int g, int m, int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int tn = tile_n(m);
  const long long blocks = (long long)s * ((n + tn - 1) / tn);
  const long long want = (6LL * sms + blocks - 1) / blocks;
  return (int)(want < 1 ? 1 : want < g ? want : g);
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n), partial
// (s, chunks, m, n) scratch, dA (s, m, n): float32, contiguous;
// m <= quadform_diag_da_max_m(), 1 <= chunks <= g.  Returns
// cudaGetLastError() after both launches (or the first error).
extern "C" int quadform_diag_da_launch(const float* A, const float* W, const float* vbar,
                                       float* partial, float* dA, int s, int g, int m, int n,
                                       int chunks, void* stream) {
  if (chunks < 1 || chunks > g) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tile_n(m) == 64 ? launch<64>(A, W, vbar, partial, dA, s, g, m, n, chunks, st)
                         : launch<32>(A, W, vbar, partial, dA, s, g, m, n, chunks, st);
}
