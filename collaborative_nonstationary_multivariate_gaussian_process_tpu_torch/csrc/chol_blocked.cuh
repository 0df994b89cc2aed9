// Blocked Cholesky factor of one matrix per thread block, for Hopper
// (sm_90a): csrc/cholesky.cu's "one_block" route (its default below the
// crossover, M < 128, and the route a caller may force at any M up to
// ~3400).
//
// The matrix lives in global memory (at M up to 3400 one f32 matrix is up to
// 46 MB, and the few matrices of a call stay in the 50 MB L2); only the
// pieces a step reuses go through shared memory.
//
// Factor (right-looking, in place on the lower triangle of L) in two levels,
// the arithmetic of cuSOLVER's batched potrf and of csrc/chol_inv.cu's
// resident route (bit for bit; PERF.md): per inner block column k0 of
// kNB = 16, inside an outer block column of kOuter = 64,
//   (a) the diagonal block is loaded into shared memory and factored by a
//       right-looking column sweep: the pivot's reciprocal, one FMA a term
//       (one barrier pair per column);
//   (b) panel rows below it are solved against it in the same arithmetic,
//       one thread per row, the row held in registers: P = A21 L11^-T;
//       written to L and to shared memory;
//   (c) the rest of the outer block column takes A -= P P^T: one warp per
//       row, lanes across its columns, the two panel rows read from shared
//       memory (row stride kNB + 1: conflict-free);
// and once per outer block column the trailing lower triangle takes the
// 64-term update, 64 x 64 tiles at a time, both 64 x 64 slices of the outer
// panel staged in shared memory.  Every update sums its terms from zero in
// order and subtracts once.
//
// A pivot that is <= 0 or not finite makes `factor` return false in every
// thread of the block at once (the pivot is read from shared memory after a
// barrier), so the caller's failure branch is uniform.
//
// On the host: `max_m` and `launch`, the opt-in query and the largest M.
#pragma once

#include <cuda_runtime.h>

namespace chol_blocked {

constexpr int kThreads = 512;
constexpr int kNB = 16;
constexpr int kOuter = 64;
constexpr int kLd = kNB + 1;      // row stride of the diagonal block and the panel rows
constexpr int kTile = 64;         // trailing-update tile
constexpr int kLdT = kOuter + 1;  // row stride of a staged outer-panel slice

__host__ __device__ inline size_t smem_floats(int m) {
  const size_t panel = (size_t)m * kLd, tiles = (size_t)2 * kTile * kLdT;
  return (size_t)kNB * kLd + (panel > tiles ? panel : tiles);
}

__host__ __device__ inline size_t smem_bytes(int m) { return smem_floats(m) * sizeof(float); }

// In place on the lower triangle of L (m x m, row-major, global memory):
// returns true with L's lower triangle the Cholesky factor, or false (in
// every thread) at the first pivot that is <= 0 or not finite.  The upper
// triangle is neither read nor written.
__device__ inline bool factor(float* L, int m, float* smem) {
  float* D = smem;             // kNB x kLd, the diagonal block
  float* P = smem + kNB * kLd;  // (m - k1) x kLd, the panel below it; then the staged tiles
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  for (int o0 = 0; o0 < m; o0 += kOuter) {
    const int o1 = min(m, o0 + kOuter);
    for (int k0 = o0; k0 < o1; k0 += kNB) {
      const int kb = min(kNB, o1 - k0);
      const int k1 = k0 + kb;
      // (a) the diagonal block, factored in shared memory
      for (int e = tid; e < kb * kb; e += nt) {
        const int i = e / kb, j = e % kb;
        D[i * kLd + j] = (j <= i) ? L[(size_t)(k0 + i) * m + k0 + j] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < kb; ++j) {
        const float djj = D[j * kLd + j];  // same value in every thread
        if (!(djj > 0.0f) || !isfinite(djj)) return false;
        const float ljj = sqrtf(djj);
        const float rinv = 1.0f / ljj;
        for (int i = j + 1 + tid; i < kb; i += nt) D[i * kLd + j] *= rinv;
        __syncthreads();
        if (tid == 0) D[j * kLd + j] = ljj;
        const int r = kb - j - 1;
        for (int e = tid; e < r * r; e += nt) {
          const int i = j + 1 + e / r, c = j + 1 + e % r;
          if (c <= i) D[i * kLd + c] = fmaf(-D[i * kLd + j], D[c * kLd + j], D[i * kLd + c]);
        }
        __syncthreads();
      }
      for (int e = tid; e < kb * kb; e += nt) {
        const int i = e / kb, j = e % kb;
        if (j <= i) L[(size_t)(k0 + i) * m + k0 + j] = D[i * kLd + j];
      }
      // (b) the panel: row i of A21 solved against L11^T in registers
      for (int i = k1 + tid; i < m; i += nt) {
        float p[kNB];
#pragma unroll
        for (int t = 0; t < kNB; ++t) p[t] = L[(size_t)i * m + k0 + t];  // kb == kNB here
#pragma unroll
        for (int t = 0; t < kNB; ++t) {
          float acc = p[t];
#pragma unroll
          for (int s = 0; s < t; ++s) acc = fmaf(-p[s], D[t * kLd + s], acc);
          p[t] = acc * (1.0f / D[t * kLd + t]);
        }
#pragma unroll
        for (int t = 0; t < kNB; ++t) {
          L[(size_t)i * m + k0 + t] = p[t];
          P[(i - k1) * kLd + t] = p[t];
        }
      }
      __syncthreads();
      // (c) the rest of the outer block column: A[k1:, k1:o1] -= P P^T
      for (int i = k1 + warp; i < m; i += nwarps) {
        const float* pi = P + (i - k1) * kLd;
        for (int j = k1 + lane; j < o1 && j <= i; j += 32) {
          const float* pj = P + (j - k1) * kLd;
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < kNB; ++t) acc = fmaf(pi[t], pj[t], acc);
          L[(size_t)i * m + j] -= acc;
        }
      }
      __syncthreads();
    }
    // the trailing lower triangle: A22 -= P P^T over the outer panel's columns
    const int w = o1 - o0, nbt = (m - o1 + kTile - 1) / kTile;
    float* Ti = P;                // kTile x kLdT: rows i0.. of the outer panel
    float* Tj = P + kTile * kLdT;  // the same for the tile's columns
    const int ty = tid >> 4, tx = tid & 15;  // rows ty, ty + 32; columns tx + 16 c
    for (int t = 0; t < nbt * (nbt + 1) / 2; ++t) {
      int bi = 0;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      const int bj = t - bi * (bi + 1) / 2;
      const int i0 = o1 + bi * kTile, j0 = o1 + bj * kTile;
      for (int e = tid; e < kTile * w; e += nt) {
        const int r = e / w, k = e % w;
        Ti[r * kLdT + k] = i0 + r < m ? L[(size_t)(i0 + r) * m + o0 + k] : 0.0f;
        Tj[r * kLdT + k] = j0 + r < m ? L[(size_t)(j0 + r) * m + o0 + k] : 0.0f;
      }
      __syncthreads();
      float acc[2][4] = {};
      for (int k = 0; k < w; ++k) {
        const float a0 = Ti[ty * kLdT + k], a1 = Ti[(ty + 32) * kLdT + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = Tj[(tx + 16 * c) * kLdT + k];
          acc[0][c] = fmaf(a0, b, acc[0][c]);
          acc[1][c] = fmaf(a1, b, acc[1][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + ty + 32 * r, j = j0 + tx + 16 * c;
          if (i < m && j <= i) L[(size_t)i * m + j] -= acc[r][c];
        }
      __syncthreads();
    }
  }
  return true;
}

// ---- host side

// The current device's opt-in shared memory per block, or -1.
inline int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Largest m `factor` takes in one block on the current device, or -1 if the
// device cannot be queried.
inline int max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (smem_bytes(m + 1) <= (size_t)optin) ++m;
  return m;
}

// Launches `kernel` over `batch` matrices of size m, one block each, with
// smem_bytes(m) of dynamic shared memory.  Returns cudaGetLastError() (or
// the error of the opt-in, or cudaErrorInvalidValue if m is too large).
template <class Kernel, class... Args>
int launch(Kernel kernel, int batch, int m, cudaStream_t stream, Args... args) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(m);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace chol_blocked
