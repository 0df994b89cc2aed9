// The multi-CTA blocked Cholesky factor for Hopper (sm_90a), shared by
// csrc/cholesky.cu (its "multi_cta" route) and csrc/chol_inv.cu (the factor
// of its multi-CTA route).
//
// A blocked right-looking factor that spreads each matrix over many CTAs, in
// place on L (global memory; the few matrices of a call stay in the 50 MB L2).
// Per block column k0 (NB = 32):
//   panel  - CTAs over row tiles (64 rows) x batch: each CTA factors the
//            NB x NB diagonal block itself (one warp, the rows in registers,
//            shuffles, no barrier; every CTA of a member gets the same
//            factor), CTA 0 writes it to a scratch buffer (`diag`: the other
//            CTAs of the phase still read the block from L; a last pass
//            copies it into L), then each thread solves one row of the
//            panel, P = A21 L11^-T, staged through shared memory so that the
//            global reads and writes are coalesced;
//   update - A22 -= P P^T over 64 x 64 tiles of the trailing lower triangle
//            only, x batch: the two 64 x 32 slices of P staged in shared
//            memory, a 4 x 4 register tile of FP32 FMAs per thread.
// The steps run as a host loop of launches on one stream, 2 per step, all
// enqueued by one call of the entry that includes this header.
//
// Failure semantics follow jnp.linalg.cholesky: a pivot that is <= 0 or not
// finite makes the member's lower triangle NaN.  A member's flag in global
// memory (`flags`, zeroed by the caller) is set by the CTA that writes its
// diagonal block; every later phase reads it once per CTA (thread 0, then a
// barrier) and skips a failed member, and the finish pass writes the NaNs.
#pragma once

#include <cuda_runtime.h>

namespace chol_multi_cta {

constexpr int kNB = 32;            // block column width
constexpr int kTile = 64;          // trailing-update tile
constexpr int kThreads = 256;      // every multi-CTA kernel
constexpr int kPanelRows = 64;     // panel rows per CTA
constexpr int kLdP = kTile + 4;    // row stride of a staged P^T slice (float4 rows)
constexpr int kLdR = kNB + 1;      // row stride of the staged panel rows
constexpr int kMaxM = 16384;

constexpr size_t kPanelSmem = (size_t)(kNB * kLdR + kPanelRows * kLdR) * sizeof(float);
constexpr size_t kUpdateSmem = (size_t)2 * kNB * kLdP * sizeof(float);

__host__ __device__ inline int blocks(int m) { return (m + kNB - 1) / kNB; }

__host__ __device__ inline int rows_below(int m, int k0) {
  return k0 + kNB < m ? m - k0 - kNB : 0;
}

__host__ __device__ inline int panel_tiles(int m, int k0) {
  const int rows = rows_below(m, k0);
  return rows > 0 ? (rows + kPanelRows - 1) / kPanelRows : 1;  // >= 1: the diagonal block
}

__host__ __device__ inline int update_tiles(int m, int k0) {
  const int rows = rows_below(m, k0);
  const int nb = (rows + kTile - 1) / kTile;
  return nb * (nb + 1) / 2;
}

// Whether member b failed in an earlier step, the same in every thread of
// the block (a panel CTA of this step may be setting the flag meanwhile):
// thread 0 reads it into `failed`, which the caller reads after a barrier.
__device__ inline void read_flag(const int* flags, int b, int* failed) {
  if (threadIdx.x == 0) *failed = *(volatile const int*)(flags + b);
}

__global__ void copy_lower(const float* __restrict__ a, float* l, int m) {
  const size_t base = (size_t)blockIdx.y * m * m;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < (size_t)m * m;
       idx += (size_t)gridDim.x * blockDim.x)
    l[base + idx] = (idx % m <= idx / m) ? a[base + idx] : 0.0f;
}

// Panel of block column k0: row tile t (blockIdx.x) of member b (blockIdx.y).
__global__ void __launch_bounds__(kThreads)
    panel_kernel(float* L, int* flags, float* diag, int m, int k0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x, b = blockIdx.y;
  float* Lb = L + (size_t)b * m * m;
  float* D = smem;                // kNB x kLdR: the diagonal block
  float* R = smem + kNB * kLdR;   // kPanelRows x kLdR: this tile's panel rows
  __shared__ float dinv[kNB];     // 1 / L11's diagonal
  __shared__ int failed, bad;
  const int tid = threadIdx.x, lane = tid & 31;
  const int kb = min(kNB, m - k0), k1 = k0 + kb;
  const int r0 = k1 + t * kPanelRows;
  const int nr = min(kPanelRows, m - r0);  // <= 0: no rows below the last diagonal block

  // the flag, the diagonal block and this tile's rows, loaded together so
  // that their latencies overlap (a failed member's loads are harmless)
  read_flag(flags, b, &failed);
#pragma unroll 4
  for (int e = tid; e < kNB * kNB; e += kThreads) {
    const int i = e / kNB, j = e % kNB;
    D[i * kLdR + j] = (i < kb && j <= i) ? Lb[(size_t)(k0 + i) * m + k0 + j] : 0.0f;
  }
#pragma unroll 8
  for (int e = tid; e < nr * kNB; e += kThreads) {
    const int r = e / kNB, j = e % kNB;
    R[r * kLdR + j] = Lb[(size_t)(r0 + r) * m + k0 + j];
  }
  __syncthreads();
  if (failed) return;
  if (tid < 32) {  // one warp factors D, lane i holding row i
    float row[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) row[j] = D[lane * kLdR + j];
    bool ok = true;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      if (j < kb) {
        const float djj = __shfl_sync(0xffffffffu, row[j], j);
        ok = ok && djj > 0.0f && isfinite(djj);
        const float ljj = sqrtf(djj), rinv = 1.0f / ljj;
        if (lane == j) row[j] = ljj, dinv[j] = rinv;
        else if (lane > j) row[j] *= rinv;
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) {
          const float lcj = __shfl_sync(0xffffffffu, row[j], c);
          if (lane >= c) row[c] = fmaf(-row[j], lcj, row[c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) D[lane * kLdR + j] = j <= lane ? row[j] : 0.0f;
    if (lane == 0) bad = !ok;
  }
  __syncthreads();
  if (bad) {
    if (t == 0 && tid == 0) flags[b] = 1;
    return;
  }
  if (t == 0) {
    float* Db = diag + ((size_t)b * blocks(m) + k0 / kNB) * kNB * kNB;
    for (int e = tid; e < kNB * kNB; e += kThreads) Db[e] = D[(e / kNB) * kLdR + e % kNB];
  }
  if (nr <= 0) return;  // uniform
  if (tid < nr) {  // row tid of A21 solved against L11^T (kb == kNB here)
    float p[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) p[j] = R[tid * kLdR + j];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      float acc = p[j];
#pragma unroll
      for (int s = 0; s < j; ++s) acc = fmaf(-p[s], D[j * kLdR + s], acc);
      p[j] = acc * dinv[j];
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) R[tid * kLdR + j] = p[j];
  }
  __syncthreads();
  for (int e = tid; e < nr * kNB; e += kThreads) {
    const int r = e / kNB, j = e % kNB;
    Lb[(size_t)(r0 + r) * m + k0 + j] = R[r * kLdR + j];
  }
}

// Update of block column k0: tile t (blockIdx.x) of the trailing lower
// triangle of member b (blockIdx.y).
__global__ void __launch_bounds__(kThreads) update_kernel(float* L, const int* flags, int m, int k0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x, b = blockIdx.y;
  __shared__ int failed;
  read_flag(flags, b, &failed);
  float* Lb = L + (size_t)b * m * m;
  float* Pi = smem;               // kNB x kLdP: P[i0 + r, k] at Pi[k][r]
  float* Pj = smem + kNB * kLdP;  // the same for the tile's columns
  const int tid = threadIdx.x;
  const int k1 = k0 + kNB;
  int bi = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);  // t = bi (bi + 1) / 2 + bj
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int i0 = k1 + bi * kTile, j0 = k1 + bj * kTile;
  const int ty = tid / 16, tx = tid % 16;

  // this thread's 4 x 4 entries of the tile, loaded first so that their
  // latency overlaps the staging of P
  float cur[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx * 4 + j;
      cur[i][j] = r < m && c <= r ? Lb[(size_t)r * m + c] : 0.0f;
    }
  }
  for (int e = tid; e < kTile * kNB; e += kThreads) {
    const int r = e / kNB, k = e % kNB;
    Pi[k * kLdP + r] = i0 + r < m ? Lb[(size_t)(i0 + r) * m + k0 + k] : 0.0f;
    Pj[k * kLdP + r] = j0 + r < m ? Lb[(size_t)(j0 + r) * m + k0 + k] : 0.0f;
  }
  __syncthreads();
  if (failed) return;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kNB; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(Pi + k * kLdP + ty * 4);
    const float4 c = *reinterpret_cast<const float4*>(Pj + k * kLdP + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx * 4 + j;
      if (r < m && c <= r) Lb[(size_t)r * m + c] = cur[i][j] - acc[i][j];
    }
  }
}

// Member b's (blockIdx.y) lower triangle: NaN if it failed, else its
// diagonal blocks' entries from `diag`.
__global__ void finish_kernel(float* L, const int* flags, const float* diag, int m) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= (size_t)m * m) return;
  const int r = (int)(idx / m), c = (int)(idx % m);
  if (c > r) return;
  float* x = L + (size_t)b * m * m + idx;
  if (flags[b]) {
    *x = __int_as_float(0x7fc00000);
  } else if (r / kNB == c / kNB) {
    *x = diag[(((size_t)b * blocks(m) + r / kNB) * kNB + r % kNB) * kNB + c % kNB];
  }
}

// Enqueues the factor of `batch` matrices (m x m, row-major) in place on
// L, whose lower triangle holds K's and whose upper triangle is zero:
// every step's panel and update launches, then the finish pass.  flags:
// (batch,) int32 zeros; diag: (batch, blocks(m), kNB, kNB) float32 scratch.
// Returns the first launch error.
inline int factor_launches(float* l, int* flags, float* diag, int batch, int m, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  for (int k0 = 0; k0 < m && err == cudaSuccess; k0 += kNB) {
    panel_kernel<<<dim3(panel_tiles(m, k0), batch), kThreads, kPanelSmem, st>>>(l, flags, diag, m,
                                                                              k0);
    err = cudaGetLastError();
    const int nu = update_tiles(m, k0);
    if (nu && err == cudaSuccess) {
      update_kernel<<<dim3(nu, batch), kThreads, kUpdateSmem, st>>>(l, flags, m, k0);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<dim3((m * m + kThreads - 1) / kThreads, batch), kThreads, 0, st>>>(l, flags, diag,
                                                                                   m);
  return (int)cudaGetLastError();
}

}  // namespace chol_multi_cta
