// Blocked Cholesky factor and blocked triangular inverse of one matrix per
// thread block, for Hopper (sm_90a).  Shared by csrc/cholesky.cu and
// csrc/chol_inv.cu.
//
// The matrix lives in global memory (at the sizes of the path, M = 100-2048,
// one f32 matrix is 40 KB-16 MB, and the batch of the few matrices a call
// factors stays in the 50 MB L2); only the pieces a step reuses go through
// shared memory: the NB x NB diagonal block, the panel of NB columns below
// it, and a segment of NB rows of L for the inverse.
//
// Factor (right-looking, in place on the lower triangle of L), for each
// block column k0 (width NB):
//   (a) the diagonal block is loaded into shared memory and factored by a
//       right-looking column sweep (one barrier pair per column);
//   (b) panel rows below it are solved against it, one thread per row, the
//       row held in registers: P = A21 L11^-T; written to L and to shared
//       memory;
//   (c) the trailing lower triangle takes A22 -= P P^T: one warp per row,
//       lanes across its columns (coalesced in L), the two panel rows read
//       from shared memory (row stride NB + 1: conflict-free).
// Inverse (block forward substitution), for each block row J = [j0, j0+NB):
//   X[J, c] = L_JJ^-1 (E_J[:, c] - L[J, :j0] X[:j0, c])  for c < j0 + NB,
// one thread per column c with NB sums in registers (each X[s, c] read from
// global memory once per block row, coalesced over c), L[J, :j0] staged in
// shared memory in segments and read as broadcasts, then the NB x NB
// triangle solved in registers.
//
// A pivot that is <= 0 or not finite makes `factor` return false in every
// thread of the block at once (the pivot is read from shared memory after a
// barrier), so the caller's failure branch is uniform.
//
// On the host: `max_m` and `launch`, the opt-in query, the largest M and the
// choice of NB that both kernels' entries share.
#pragma once

#include <cuda_runtime.h>

namespace chol_blocked {

constexpr int kThreads = 512;
constexpr int kSeg = 256;  // columns of L[J, :j0] staged at a time by the inverse

template <int NB>
__host__ __device__ inline size_t factor_smem_floats(int m) {
  return (size_t)(NB + m) * (NB + 1);  // diagonal block + panel rows
}

template <int NB>
__host__ __device__ inline size_t inverse_smem_floats() {
  return (size_t)NB * (NB + 1) + (size_t)NB * kSeg;  // L_JJ + a segment of L[J, :j0]
}

template <int NB>
__host__ __device__ inline size_t smem_bytes(int m) {
  const size_t f = factor_smem_floats<NB>(m), i = inverse_smem_floats<NB>();
  return (f > i ? f : i) * sizeof(float);
}

// In place on the lower triangle of L (m x m, row-major, global memory):
// returns true with L's lower triangle the Cholesky factor, or false (in
// every thread) at the first pivot that is <= 0 or not finite.  The upper
// triangle is neither read nor written.
template <int NB>
__device__ bool factor(float* L, int m, float* smem) {
  constexpr int ld = NB + 1;
  float* D = smem;            // NB x ld, the diagonal block
  float* P = smem + NB * ld;  // (m - k1) x ld, the panel below it
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  for (int k0 = 0; k0 < m; k0 += NB) {
    const int kb = min(NB, m - k0);
    const int k1 = k0 + kb;
    // (a) the diagonal block, factored in shared memory
    for (int e = tid; e < kb * kb; e += nt) {
      const int i = e / kb, j = e % kb;
      D[i * ld + j] = (j <= i) ? L[(size_t)(k0 + i) * m + k0 + j] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kb; ++j) {
      const float djj = D[j * ld + j];  // same value in every thread
      if (!(djj > 0.0f) || !isfinite(djj)) return false;
      const float ljj = sqrtf(djj);
      const float rinv = 1.0f / ljj;
      for (int i = j + 1 + tid; i < kb; i += nt) D[i * ld + j] *= rinv;
      __syncthreads();
      if (tid == 0) D[j * ld + j] = ljj;
      const int r = kb - j - 1;
      for (int e = tid; e < r * r; e += nt) {
        const int i = j + 1 + e / r, c = j + 1 + e % r;
        if (c <= i) D[i * ld + c] = fmaf(-D[i * ld + j], D[c * ld + j], D[i * ld + c]);
      }
      __syncthreads();
    }
    for (int e = tid; e < kb * kb; e += nt) {
      const int i = e / kb, j = e % kb;
      if (j <= i) L[(size_t)(k0 + i) * m + k0 + j] = D[i * ld + j];
    }
    // (b) the panel: row i of A21 solved against L11^T in registers
    for (int i = k1 + tid; i < m; i += nt) {
      float p[NB];
#pragma unroll
      for (int t = 0; t < NB; ++t) p[t] = L[(size_t)i * m + k0 + t];  // kb == NB here
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        float acc = p[t];
#pragma unroll
        for (int s = 0; s < t; ++s) acc = fmaf(-p[s], D[t * ld + s], acc);
        p[t] = acc / D[t * ld + t];
      }
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        L[(size_t)i * m + k0 + t] = p[t];
        P[(i - k1) * ld + t] = p[t];
      }
    }
    __syncthreads();
    // (c) the trailing lower triangle: A22 -= P P^T
    for (int i = k1 + warp; i < m; i += nwarps) {
      const float* pi = P + (i - k1) * ld;
      for (int j = k1 + lane; j <= i; j += 32) {
        const float* pj = P + (j - k1) * ld;
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NB; ++t) acc = fmaf(pi[t], pj[t], acc);
        L[(size_t)i * m + j] -= acc;
      }
    }
    __syncthreads();
  }
  return true;
}

// X = L^-1 (m x m, row-major, global memory) from the lower triangle of L,
// zeros above the diagonal.  X must not alias L.
template <int NB>
__device__ void inverse(const float* L, float* X, int m, float* smem) {
  constexpr int ld = NB + 1;
  float* D = smem;            // NB x ld, L_JJ
  float* R = smem + NB * ld;  // NB x kSeg, a segment of L[J, :j0]
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int j0 = 0; j0 < m; j0 += NB) {
    const int jb = min(NB, m - j0);
    const int j1 = j0 + jb;
    for (int e = tid; e < jb * jb; e += nt) {
      const int r = e / jb, t = e % jb;
      D[r * ld + t] = (t <= r) ? L[(size_t)(j0 + r) * m + j0 + t] : 0.0f;
    }
    for (int cbase = 0; cbase < j1; cbase += nt) {
      const int c = cbase + tid;
      float acc[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) acc[r] = 0.0f;
      for (int s0 = 0; s0 < j0; s0 += kSeg) {
        const int sb = min(kSeg, j0 - s0);
        __syncthreads();  // the previous segment has been read
        for (int e = tid; e < jb * sb; e += nt) {
          const int r = e / sb, s = e % sb;
          R[r * kSeg + s] = L[(size_t)(j0 + r) * m + s0 + s];
        }
        __syncthreads();
        if (c < j1) {
          for (int s = 0; s < sb; ++s) {
            const float xv = X[(size_t)(s0 + s) * m + c];
#pragma unroll
            for (int r = 0; r < NB; ++r) acc[r] = fmaf(R[r * kSeg + s], xv, acc[r]);
          }
        }
      }
      __syncthreads();  // D is loaded (when j0 == 0 no segment loop ran)
      if (c < j1) {
        float x[NB];
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          if (r < jb) {
            float v = ((j0 + r == c) ? 1.0f : 0.0f) - acc[r];
#pragma unroll
            for (int t = 0; t < r; ++t) v = fmaf(-D[r * ld + t], x[t], v);
            x[r] = v / D[r * ld + r];
            X[(size_t)(j0 + r) * m + c] = x[r];
          }
        }
      }
    }
    // zeros right of the diagonal block
    const int w = m - j1;
    for (int e = tid; e < jb * w; e += nt) {
      const int r = e / w, c = j1 + e % w;
      X[(size_t)(j0 + r) * m + c] = 0.0f;
    }
    __syncthreads();  // rows J of X are final before the next block row reads them
  }
}

// ---- host side, shared by the entries of the two kernels

// The current device's opt-in shared memory per block, or -1.
inline int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Largest m a kernel of this header takes on the current device (NB = 16),
// or -1 if the device cannot be queried.
inline int max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (smem_bytes<16>(m + 1) <= (size_t)optin) ++m;
  return m;
}

// Launches kernel<NB> over `batch` matrices of size m, one block each:
// `pick(nb)` returns the instance for NB = nb, NB = 32 where its shared
// memory fits the opt-in limit, else 16.  Returns cudaGetLastError() (or the
// error of the opt-in, or cudaErrorInvalidValue if m is too large).
template <class Pick, class... Args>
int launch(Pick pick, int batch, int m, cudaStream_t stream, Args... args) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  int nb = 0;
  size_t smem = 0;
  if (smem_bytes<32>(m) <= (size_t)optin) {
    nb = 32, smem = smem_bytes<32>(m);
  } else if (smem_bytes<16>(m) <= (size_t)optin) {
    nb = 16, smem = smem_bytes<16>(m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = pick(nb);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace chol_blocked
