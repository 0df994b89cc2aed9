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
// Bounds on the H100.  Per (g, n), M (M + 1) / 2 FMAs recompute C over the
// triangle and M (M + 1) / 2 more give dW's triangle: 2 G N M (M + 1) flops.
// At ECoG width (G = 3003, N = 512) that is 31.1 GFLOP at M = 100 and 123.6
// at M = 200: 0.4636 and 1.8450 ms at the 67 TFLOP/s FP32 rate of the CUDA
// cores.  On the tensor cores (495 TFLOP/s dense TF32) 3xTF32 throughout
// (three TF32 products per FP32 product) would take 0.188 and 0.749 ms;
// this kernel takes six for C and three for the second product (its
// split, below), 4.5 on average: 0.282 and 1.124 ms, its bound.  All lie
// above the byte bound (W's triangle read and dW written, 180 MB at M = 100
// and 721 MB at M = 200: 0.054 and 0.216 ms at 3.35 TB/s).  The library
// route (two einsums) also writes and reads the (G, N, M) intermediates C
// and E.
//
// Design: k-panels.  Column k of dW needs only column k of C, and both
// products of a panel of KP = 32 columns [k0, k0 + 32) read the same slab,
// W_g[k0:M, k0:k0+32] (W is lower-triangular), and rows k0:M of A.  So a
// block takes one (group g, panel, draw s) and one warp per 32 of the
// panel's rows M - k0 (4, 8 or 16 warps).  One grid takes all the panels,
// its blocks sized for the first; where M is above 128 and a panel's grid
// alone fills the card 8 blocks an SM deep, one grid per panel, each block
// sized by its panel's rows, so a late panel launches no idle warps
// (`kOneGridMaxM`: measured, below).  Shared memory
// holds the slab and two A tiles (rows k0:M x 32 columns n), O(M KP) and not
// O(M^2), which takes M up to 512 (`quadform_diag_dw_max_m`: 16 warps of 32
// rows; the single-A-tile design took 704).  A 64-column A tile doubles the
// shared memory, halves the blocks an SM holds, and was 16-19% slower on the
// H100 (2.78 against 2.41 ms at M = 100, 9.36 against 7.88 at M = 200).
// Panels of dW are independent: no reduction crosses blocks, no atomics, and
// the result is deterministic.  Per N tile, on the tensor cores by split
// operands (csrc/qf_mma.cuh): C = A^T W with three TF32 pieces a float32
// operand (six TF32 products: its sums cancel, and 3xTF32 there errs 4-6x
// more than a float32 einsum on the path's inputs,
// tests/test_torch_qf_tf32x3.py), the second product in 3xTF32:
//   (a) C[n, panel] = sum_{m >= k0} A[m, n] W[m, panel]: 2 x 4 tiles of 16
//       (n) x 8 (k) over the warps (`qf::panel_c`), each running the whole
//       row loop in steps of 8 from the first row its columns meet in the
//       triangle; scaled by 2 vbar[g, n] into E in shared memory;
//   (b) dW[m, panel] += sum_n A[m, n] E[n, panel]: each warp holds two
//       16-row tiles x 32 columns of the panel's dW as m16n8 accumulators
//       (the 8-column tiles above the diagonal skipped), which leave
//       registers once, at the end.
// While an N tile is multiplied, the next one of A is copied in by
// `cp.async` (16 bytes where N is a multiple of 4); the slab comes the same
// way once, its zeros above the diagonal and beyond M from the copy's zero
// fill.  W is read in its (G, M, M) layout: the TPU kernel's flattened WT
// operand and 0/1 selector matmuls existed only because Mosaic could not
// relayout inside a kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_mma.cuh"

namespace {

constexpr int kKP = 32;  // columns k per panel
constexpr int kTN = 32;  // columns n per A tile
// One grid runs all the panels, its blocks sized for the first, unless M is
// above kOneGridMaxM and a panel's grid alone (G x S blocks) holds at least
// kPanelGridMinBlocksPerSM blocks per SM: then one grid per panel, each
// sized by its rows.  On the H100 (M, G) = (200, 3003) took 7.87 ms by panel
// grids and 8.33 by one grid; (100, 3003) 2.47 and 2.37, (200, 78) 0.65 and
// 0.24, (100, 15) at N = 2000 1.12 and 0.45.
constexpr int kOneGridMaxM = 4 * kKP;
constexpr int kPanelGridMinBlocksPerSM = 8;
// TF32 pieces of each operand (csrc/qf_mma.cuh): three for C = A^T W, whose
// sums cancel, two (3xTF32) for the product after it
constexpr int kPiecesC = 3;
constexpr int kPiecesD = 2;
constexpr int kMT = 2;      // 16-row tiles of dW a warp holds
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 16;

__host__ __device__ inline int rows16(int m) { return 16 * ((m + 15) / 16); }

// Warps of a block for a panel of `rows` rows: kMT 16-row tiles each, and
// 4, 8 or 16 of them (a multiple of the 4 column tiles of C, and a divisor
// or multiple of its n-tiles: `qf::panel_c`).
inline int block_warps(int rows) {
  const int need = (rows16(rows) / 16 + kMT - 1) / kMT;
  int w = kMinWarps;
  while (w < need) w *= 2;
  return w;
}

// Dynamic shared memory of one block for a panel of `rows` rows: the slab,
// the E tile and two A tiles.
size_t smem_bytes(int rows) {
  return ((size_t)rows16(rows) * kKP + (size_t)kTN * kKP + 2 * (size_t)rows16(rows) * kTN) *
         sizeof(float);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    quadform_diag_dw_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ vbar, float* __restrict__ dW, int m, int n,
                            int g, int k0_first, int vec_a, int vec_w) {
  const int k0 = k0_first + blockIdx.y * kKP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = m - k0;  // slab rows: m = k0 + r
  const int rpad = rows16(rows);
  float* Ws = smem;             // rpad x kKP: the slab W[k0 + r, k0 + kk], zero above the diagonal
  float* Es = Ws + rpad * kKP;  // kTN x kKP: the E tile
  float* Abuf = Es + kTN * kKP;  // 2 x rpad x kTN: rows k0.. of two A tiles

  const int gi = blockIdx.x;
  const int s = blockIdx.z;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, t = lane & 3;
  const float* Wg = W + ((size_t)s * g + gi) * m * m;
  const float* Ab = A + (size_t)s * m * n + (size_t)k0 * n;
  const float* vg = vbar + ((size_t)s * g + gi) * n;
  float* dWg = dW + ((size_t)s * g + gi) * m * m;
  const int ntiles = (n + kTN - 1) / kTN;

  auto stage_a = [&](int tile) {
    qf::stage_tile<kTN>(Abuf + (tile & 1) * rpad * kTN, Ab + tile * kTN, n, rpad, rows,
                       n - tile * kTN, qf::kNoTriangle, vec_a != 0);
  };
  qf::stage_tile<kKP>(Ws, Wg + (size_t)k0 * m + k0, m, rpad, rows, rows, 0, vec_w != 0);
  if (ntiles > 0) stage_a(0);
  qf::cp_async_commit();

  float acc[kMT][kKP / 8][4];
#pragma unroll
  for (int j = 0; j < kMT; ++j)
#pragma unroll
    for (int kt = 0; kt < kKP / 8; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][kt][e] = 0.0f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int n0 = tile * kTN;
    const float* As = Abuf + (tile & 1) * rpad * kTN;
    if (tile + 1 < ntiles) stage_a(tile + 1);
    qf::cp_async_commit();
    qf::cp_async_wait<1>();  // this tile of A (and, first, the slab) has landed
    __syncthreads();

    // (a) C[n, kk] of this warp's tiles (16 nt.., 8 kt..), then E = 2 vbar C
    {
      float c[kTN / 16][4];
      qf::panel_c<kTN, kPiecesC>(c, As, 0, Ws, rows, warp, nwarps, lane);
      const int kt = warp & 3;
#pragma unroll
      for (int j = 0; j < kTN / 16; ++j) {
        const int nt = (warp >> 2) + (nwarps >> 2) * j;
        if (nt >= kTN / 16) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nn = 16 * nt + q + 8 * h;
          const float v = n0 + nn < n ? 2.0f * vg[n0 + nn] : 0.0f;
          const int kk = 8 * kt + 2 * t;
          Es[nn * kKP + qf::swz(nn, kk)] = v * c[j][2 * h];
          Es[nn * kKP + qf::swz(nn, kk + 1)] = v * c[j][2 * h + 1];
        }
      }
    }
    __syncthreads();

    // (b) dW[r, kk] += A[r, n] E[n, kk] for this warp's row tiles
#pragma unroll 2
    for (int nk = 0; nk < kTN / 8; ++nk) {
      qf::FragB<kPiecesD> b[kKP / 8];
#pragma unroll
      for (int kt = 0; kt < kKP / 8; ++kt) qf::load_b_kr(b[kt], Es, kKP, 8 * nk, 8 * kt, lane);
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int r0 = 16 * (warp + nwarps * j);
        if (r0 < rows) {
          qf::FragA<kPiecesD> a;
          qf::load_a_kc(a, As, kTN, r0, 8 * nk, lane);
#pragma unroll
          for (int kt = 0; kt < kKP / 8; ++kt)
            if (8 * kt <= r0 + 15) qf::mma_split(acc[j][kt], a, b[kt]);  // dW[r, kk] = 0 for kk > r
        }
      }
    }
    __syncthreads();  // this A tile and E consumed before the next copy and (a)
  }
  qf::cp_async_wait<0>();

  // the lower triangle of the panel from the accumulators
#pragma unroll
  for (int j = 0; j < kMT; ++j) {
    const int r0 = 16 * (warp + nwarps * j);
#pragma unroll
    for (int kt = 0; kt < kKP / 8; ++kt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + q + 8 * (e >> 1), kk = 8 * kt + 2 * t + (e & 1);
        if (r < rows && k0 + kk < m && kk <= r) dWg[(size_t)(k0 + r) * m + k0 + kk] = acc[j][kt][e];
      }
    }
  }
  // zeros above the diagonal in this panel's columns
  const int zrows = min(m, k0 + kKP);
  for (int i = threadIdx.x; i < zrows * kKP; i += blockDim.x) {
    const int r = i / kKP, k = k0 + i % kKP;
    if (k < m && k > r) dWg[(size_t)r * m + k] = 0.0f;
  }
}

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Whether the kernel takes a panel of `rows` rows on this device.
bool fits(int rows, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, quadform_diag_dw_kernel) != cudaSuccess) return false;
  return smem_bytes(rows) + attr.sharedSizeBytes <= (size_t)optin &&
         block_warps(rows) <= kMaxWarps && 32 * block_warps(rows) <= attr.maxThreadsPerBlock;
}

// Panels [k0_first, k0_first + 32 panels) in one grid, each block sized for
// the first (largest).
int launch(const float* A, const float* W, const float* vbar, float* dW, int s, int g, int m, int n,
           int k0_first, int panels, cudaStream_t st) {
  const int rows = m - k0_first;
  const size_t smem = smem_bytes(rows);
  cudaError_t err = cudaFuncSetAttribute(quadform_diag_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every row of the operand starts 16-byte aligned
  const int vec_a = n % 4 == 0 && (uintptr_t)A % 16 == 0;
  const int vec_w = m % 4 == 0 && (uintptr_t)W % 16 == 0;
  quadform_diag_dw_kernel<<<dim3(g, panels, s), 32 * block_warps(rows), smem, st>>>(
      A, W, vbar, dW, m, n, g, k0_first, vec_a, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest inducing size m whose first (largest) panel fits the current
// device's opt-in shared memory and 16 warps, or -1 if the
// device cannot be queried.
extern "C" int quadform_diag_dw_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits(m + 1, optin)) ++m;
  return m;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n), dW (s, g, m, m):
// float32, contiguous; m <= quadform_diag_dw_max_m().  One grid, or one
// per k-panel in order on `stream` (kOneGridMaxM).  Returns
// cudaGetLastError() after the last launch (or the first error).
extern "C" int quadform_diag_dw_launch(const float* A, const float* W, const float* vbar,
                                       float* dW, int s, int g, int m, int n, void* stream) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  if (!fits(m, optin)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  if (m <= kOneGridMaxM || (long long)g * s < kPanelGridMinBlocksPerSM * sms)
    return launch(A, W, vbar, dW, s, g, m, n, 0, (m + kKP - 1) / kKP, st);
  for (int k0 = 0; k0 < m; k0 += kKP) {
    const int err = launch(A, W, vbar, dW, s, g, m, n, k0, 1, st);
    if (err != 0) return err;
  }
  return (int)cudaSuccess;
}
