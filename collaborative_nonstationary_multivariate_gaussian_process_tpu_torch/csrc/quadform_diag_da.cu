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
// Bounds on the H100.  Per (g, n), M (M + 1) / 2 FMAs recompute C over the
// triangle and M (M + 1) / 2 more give W_g E_g^T: 2 G N M (M + 1) flops.  At
// ECoG width (G = 3003, N = 512) that is 31.1 GFLOP at M = 100 and 123.6 at
// M = 200: 0.4636 and 1.8450 ms at the 67 TFLOP/s FP32 rate of the CUDA
// cores.  On the tensor cores (495 TFLOP/s dense TF32) 3xTF32 throughout
// (three TF32 products per FP32 product) would take 0.188 and 0.749 ms;
// this kernel takes six for C and three for the second product (its
// split, below), 4.5 on average: 0.282 and 1.124 ms, its bound.  All lie
// above the byte bound (W's triangle, 60 MB at M = 100 and 241 MB at
// M = 200: 0.018 and 0.072 ms at 3.35 TB/s).
//
// Design: the sum runs over G, so a block takes one (N tile of TN columns,
// chunk of groups, draw s), 16 warps, and keeps its dA tile (M x TN) in
// registers as m16n8 accumulators, MAXT a warp.  TN is 64 where that block
// fits the opt-in shared memory (M up to 432), else 32.  It stages its A
// tile once, then walks each group of its chunk in k-panels of KP = 32
// columns [k0, k0 + 32): both products of a panel read the same slab
// W_g[k0:M, k0:k0+32] (W is lower-triangular), so shared memory holds two
// slabs and not W_g, which takes M up to 592 (`quadform_diag_da_max_m`; the
// second slab of the double buffer lowers the single-slab 704).  Per
// panel, on the tensor cores by split operands (csrc/qf_mma.cuh): C = A^T W
// with three TF32 pieces a float32 operand (six TF32 products: its sums
// cancel, and 3xTF32 there errs 4-6x more than a float32 einsum on the
// path's inputs, tests/test_torch_qf_tf32x3.py), the second product in
// 3xTF32:
//   (a) C[n, panel] = sum_{r >= k0} A[r, n] W[r, panel]: (TN / 16) x 4
//       tiles of 16 (n) x 8 (k), at most one a warp (`qf::panel_c`), each
//       running the whole row loop in steps of 8 from the first row its
//       columns meet in the triangle; scaled by 2 vbar[g, n] into E^T in
//       shared memory;
//   (b) dA[m, n] += sum_{k in panel, k <= m} W[m, k] E[n, k] into the
//       register tiles of rows m >= k0 (W[m, k] = 0 for k > m: the tiles and
//       k-steps above the triangle are skipped, at 16 rows and 8 columns).
// While a panel is multiplied, the next (group, panel)'s slab is copied in
// by `cp.async` (16 bytes where M is a multiple of 4; the zeros above the
// diagonal and beyond M come from the copy's zero fill).  Blocks of one
// chunk are adjacent in launch order, so the N tiles that share W_g read it
// from L2.  Each block writes its partial sum to a (S, chunks, M, N) buffer
// (the chunk count, `quadform_diag_da_chunks`, gives six blocks per SM); a
// second kernel adds the chunks in a fixed order.  No atomics: the result is
// deterministic.  W is read in its (G, M, M) layout (the TPU kernel's
// flattened WT/WM operands and selector matmuls existed only for Mosaic).
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_mma.cuh"

namespace {

constexpr int kKP = 32;  // columns k per panel
// TF32 pieces of each operand (csrc/qf_mma.cuh): three for C = A^T W, whose
// sums cancel, two (3xTF32) for the product after it
constexpr int kPiecesC = 3;
constexpr int kPiecesD = 2;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceThreads = 256;

__host__ __device__ inline int rows16(int m) { return 16 * ((m + 15) / 16); }

// Register tiles of dA a warp holds for inducing size m and tile width tn.
inline int tiles_per_warp(int m, int tn) {
  const int tiles = (rows16(m) / 16) * (tn / 8);
  return (tiles + kWarps - 1) / kWarps;
}

// Dynamic shared memory of one block: the A tile, E^T and two slabs.
size_t smem_bytes(int m, int tn) {
  return ((size_t)rows16(m) * tn + (size_t)kKP * tn + 2 * (size_t)rows16(m) * kKP) * sizeof(float);
}

template <int TN, int MAXT>
__global__ void __launch_bounds__(kThreads, 1)
    quadform_diag_da_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ vbar, float* __restrict__ partial, int m,
                            int n, int g, int chunks, int vec_a, int vec_w) {
  constexpr int kNT = TN / 8;                     // n-tiles of the dA tile
  static_assert(kWarps % kNT == 0, "a warp's dA tiles share one n-tile");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int mpad = rows16(m);
  float* As = smem;              // mpad x TN: the A tile, zero beyond row m and column n
  float* Et = As + mpad * TN;    // kKP x TN: E^T of the panel
  float* Wbuf = Et + kKP * TN;   // 2 x mpad x kKP: slabs W[k0 + r, k0 + kk], kk <= r

  const int n0 = blockIdx.x * TN;
  const int chunk = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, t = lane & 3;
  const int per_chunk = (g + chunks - 1) / chunks;
  const int g_lo = min(g, chunk * per_chunk);
  const int g_hi = min(g, g_lo + per_chunk);
  const int panels = (m + kKP - 1) / kKP;
  const int total = (g_hi - g_lo) * panels;  // (group, panel) pairs, group-major
  const int tiles = (mpad / 16) * kNT;

  qf::stage_tile<TN>(As, A + (size_t)s * m * n + n0, n, mpad, m, n - n0, qf::kNoTriangle,
                     vec_a != 0);
  auto stage_slab = [&](int it) {
    const int gi = g_lo + it / panels, k0 = (it % panels) * kKP;
    const float* Wg = W + ((size_t)s * g + gi) * m * m;
    qf::stage_tile<kKP>(Wbuf + (it & 1) * mpad * kKP, Wg + (size_t)k0 * m + k0, m, mpad - k0,
                        m - k0, m - k0, 0, vec_w != 0);
  };
  if (total > 0) stage_slab(0);
  qf::cp_async_commit();

  float dacc[MAXT][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int gi = g_lo + it / panels, k0 = (it % panels) * kKP;
    const int rows = m - k0;
    const float* Ws = Wbuf + (it & 1) * mpad * kKP;
    if (it + 1 < total) stage_slab(it + 1);
    qf::cp_async_commit();
    qf::cp_async_wait<1>();  // this panel's slab (and, first, the A tile) has landed
    __syncthreads();

    // (a) C[n, kk] of this warp's tiles (16 nt.., 8 kt..), then E^T = 2 vbar C^T
    {
      float c[TN / 16][4];
      qf::panel_c<TN, kPiecesC>(c, As, k0, Ws, rows, warp, kWarps, lane);
      const float* vg = vbar + ((size_t)s * g + gi) * n;
      const int kt = warp & 3;
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) {
        const int nt = (warp >> 2) + (kWarps / 4) * j;
        if (nt >= TN / 16) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nn = 16 * nt + q + 8 * h;
          const float v = n0 + nn < n ? 2.0f * vg[n0 + nn] : 0.0f;
          const int kk = 8 * kt + 2 * t;
          Et[kk * TN + qf::swz(kk, nn)] = v * c[j][2 * h];
          Et[(kk + 1) * TN + qf::swz(kk + 1, nn)] = v * c[j][2 * h + 1];
        }
      }
    }
    __syncthreads();

    // (b) dA[m, n] += W[m, panel] E^T[panel, n] over the rows m >= k0
    const int nt = warp % kNT;
    qf::FragB<kPiecesD> eb[kKP / 8];
#pragma unroll
    for (int ks = 0; ks < kKP / 8; ++ks) qf::load_b_kr(eb[ks], Et, TN, 8 * ks, 8 * nt, lane);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int mt = (warp + kWarps * j) / kNT;
      const int r0 = 16 * mt - k0;  // k0 is a multiple of 16: a tile lies wholly on one side
      if (warp + kWarps * j < tiles && r0 >= 0 && 16 * mt < m) {
#pragma unroll
        for (int ks = 0; ks < kKP / 8; ++ks) {
          if (8 * ks <= r0 + 15) {  // W[m, kk] = 0 for kk > m
            qf::FragA<kPiecesD> a;
            qf::load_a_kc(a, Ws, kKP, r0, 8 * ks, lane);
            qf::mma_split(dacc[j], a, eb[ks]);
          }
        }
      }
    }
    __syncthreads();  // the slab and E^T consumed before the next copy and (a)
  }
  qf::cp_async_wait<0>();

  float* P = partial + ((size_t)s * chunks + chunk) * m * n;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int ti = warp + kWarps * j;
    if (ti >= tiles) continue;
    const int mt = ti / kNT, col = n0 + 8 * (warp % kNT) + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + q + 8 * h;
      if (r >= m) continue;
      if (col < n) P[(size_t)r * n + col] = dacc[j][2 * h];
      if (col + 1 < n) P[(size_t)r * n + col + 1] = dacc[j][2 * h + 1];
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

// The instantiations: (TN, MAXT).  TN = 32 serves the largest M only.
using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int, int,
                        int);
struct Variant {
  int tn, maxt;
  Kernel kernel;
};
const Variant kVariants[] = {
    {64, 4, quadform_diag_da_kernel<64, 4>},
    {64, 8, quadform_diag_da_kernel<64, 8>},
    {64, 16, quadform_diag_da_kernel<64, 16>},
    {32, 16, quadform_diag_da_kernel<32, 16>},
};

bool fits(const Variant& v, int m, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, v.kernel) != cudaSuccess) return false;
  return tiles_per_warp(m, v.tn) <= v.maxt &&
         smem_bytes(m, v.tn) + attr.sharedSizeBytes <= (size_t)optin &&
         kThreads <= attr.maxThreadsPerBlock;
}

// The variant the launch takes for inducing size m (the first that fits), or
// null.
const Variant* variant(int m) {
  const int optin = optin_bytes();
  if (optin < 0) return nullptr;
  for (const Variant& v : kVariants)
    if (fits(v, m, optin)) return &v;
  return nullptr;
}

}  // namespace

// Largest inducing size m some variant takes on the current device, or -1 if
// the device cannot be queried.
extern "C" int quadform_diag_da_max_m() {
  if (optin_bytes() < 0) return -1;
  int m = 0;
  while (variant(m + 1) != nullptr) ++m;
  return m;
}

// Chunks of groups for (s, g, m, n): enough (N tile, chunk) blocks for six per
// streaming multiprocessor, at most one chunk per group; -1 if the device
// cannot be queried or takes no variant for m.
extern "C" int quadform_diag_da_chunks(int s, int g, int m, int n) {
  int dev = 0, sms = 0;
  const Variant* v = variant(m);
  if (v == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long blocks = (long long)s * ((n + v->tn - 1) / v->tn);
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
  const Variant* v = variant(m);
  if (v == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(m, v->tn);
  cudaError_t err =
      cudaFuncSetAttribute(v->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every row of the operand starts 16-byte aligned
  const int vec_a = n % 4 == 0 && (uintptr_t)A % 16 == 0;
  const int vec_w = m % 4 == 0 && (uintptr_t)W % 16 == 0;
  dim3 grid((n + v->tn - 1) / v->tn, chunks, s);
  v->kernel<<<grid, kThreads, smem, st>>>(A, W, vbar, partial, m, n, g, chunks, vec_a, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mn = m * n;
  dim3 rgrid((mn + kReduceThreads - 1) / kReduceThreads, s);
  quadform_diag_da_reduce<<<rgrid, kReduceThreads, 0, st>>>(partial, dA, chunks, mn);
  return (int)cudaGetLastError();
}
