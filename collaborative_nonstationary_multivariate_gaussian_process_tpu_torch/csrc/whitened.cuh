// Packed triangular layouts and shared pieces of the whitened-factor
// kernels (csrc/whitened_factors.cu and csrc/whitened_factors_bwd.cu).
//
// A group's M x M factors live in shared memory as 4-row blocks of a
// triangle, M padded to mp = a multiple of 4 (nb = mp / 4 row blocks), so
// that every row starts 16-byte aligned and a lane's 4 columns are one
// float4:
//   - lower-packed: row r = 4b + q holds columns [0, 4b + 4), the lower
//     triangle and the rest of its diagonal 4 x 4 block;
//   - upper-packed: row r = 4b + q holds columns [4b, mp), the upper
//     triangle and the rest of its diagonal block.
// Each takes 8 nb (nb + 1) floats, about half of mp^2: two of them fit the
// H100's 227 KB of shared memory a block up to mp = 236.
#pragma once

#include <cuda_runtime.h>

namespace wf {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;

__host__ __device__ inline int pad4(int m) { return (m + 3) & ~3; }
__host__ __device__ inline int packed_floats(int mp) { return 2 * (mp / 4) * (mp / 4 + 1) * 4; }
// first float of row r of a lower-packed matrix
__host__ __device__ inline int lo_off(int r) {
  const int b = r >> 2, q = r & 3;
  return 4 * (b + 1) * (2 * b + q);
}
// first float of row r of an upper-packed matrix of mp columns (column 4b)
__host__ __device__ inline int up_off(int r, int mp) {
  const int b = r >> 2, q = r & 3;
  return 4 * b * mp - 8 * b * (b - 1) + q * (mp - 4 * b);
}

// Row r and first column c4 of the idx-th float4 of a lower-packed matrix
// (row block b holds 4 (b + 1) of them, 2 b (b + 1) before it).
__device__ __forceinline__ void lo_chunk(int idx, int& r, int& c4) {
  int b = (int)((sqrtf(1.0f + 2.0f * (float)idx) - 1.0f) * 0.5f);
  while (2 * (b + 1) * (b + 2) <= idx) ++b;
  while (b > 0 && 2 * b * (b + 1) > idx) --b;
  const int rem = idx - 2 * b * (b + 1);
  const int q = rem / (b + 1);
  r = 4 * b + q;
  c4 = 4 * (rem - q * (b + 1));
}

// The same float4s taken column block by column block: column block c
// holds the rows r in [4 c, mp), c mp - 2 c (c - 1) float4s before it.
// Consecutive threads then take consecutive rows of one column block, so a
// transposed write of theirs lands on consecutive words.
__device__ __forceinline__ void lo_chunk_by_column(int idx, int mp, int& r, int& c4) {
  const float a = (float)(mp + 2);
  int c = (int)((a - sqrtf(fmaxf(a * a - 8.0f * (float)idx, 0.0f))) * 0.25f);
  while (c > 0 && c * mp - 2 * c * (c - 1) > idx) --c;
  while ((c + 1) * mp - 2 * (c + 1) * c <= idx) ++c;
  r = 4 * c + idx - (c * mp - 2 * c * (c - 1));
  c4 = 4 * c;
}

// Runs use(i, load(i)) for this thread's indices i < total (strided by the
// block), kStage loads in flight at once.
constexpr int kStage = 4;
template <typename Load, typename Use>
__device__ __forceinline__ void staged(int total, Load load, Use use) {
  for (int base = threadIdx.x; base < total; base += kThreads * kStage) {
    float4 v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < total ? load(i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * kThreads;
      if (i < total) use(i, v[u]);
    }
  }
}

// The t-th item a warp takes of `count` items dealt to the block's warps in
// snake order (0..7, then 7..0, ...): with the items in order of falling
// work, each warp's next item is the lightest left; -1 past the end.
__device__ __forceinline__ int dealt(int t, int warp, int count) {
  const int round = t, pos = (round & 1) ? kWarps - 1 - warp : warp;
  const int i = round * kWarps + pos;
  return i < count ? i : -1;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

template <int J>
__device__ __forceinline__ void zero(float (&acc)[J][4][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][r][q] = 0.0f;
}

// acc[r][q] += a[r] b[q]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
}

// Four consecutive floats of a row of m, from column c: a float4 load where
// `vec` (m % 4 == 0 and the base 16-byte aligned), else scalar loads, zero
// beyond column m.  Through the read-only cache: not for what this kernel
// writes (`load_row4_rw`).
__device__ __forceinline__ float4 load_row4(const float* row, int c, int m, bool vec) {
  if (vec && c + 3 < m) return __ldg(reinterpret_cast<const float4*>(row + c));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < m ? __ldg(row + c + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load_row4_rw(const float* row, int c, int m, bool vec) {
  if (vec && c + 3 < m) return *reinterpret_cast<const float4*>(row + c);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < m ? row[c + e] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_row4(float* row, int c, int m, bool vec, const float (&v)[4]) {
  if (vec && c + 3 < m) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < m) row[c + e] = v[e];
}

// The device's opt-in shared memory a block, or -1.
inline int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Blocks of `kernel` (kThreads threads, `smem` dynamic bytes) the device
// holds at once, over all SMs; 0 if it cannot be queried.
template <typename K>
long long resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return (long long)sms * per_sm;
}

// dst upper-packed <- the lower triangle of src (m x m, row-major)
// transposed: dst row k holds src[r][k] for r in [4 (k / 4), mp), zero
// where r < k or beyond m, diag(src[k][k]) on the diagonal.  Read a float4
// of src's rows at a time, column block by column block.
template <typename Diag>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, int m, int mp, bool vec,
                                                 Diag diag) {
  staged(
      packed_floats(mp) / 4,
      [&](int i) {
        int r, c4;
        lo_chunk_by_column(i, mp, r, c4);
        return r < m ? load_row4(src + (size_t)r * m, c4, m, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      },
      [&](int i, float4 x) {
        int r, c4;
        lo_chunk_by_column(i, mp, r, c4);
        const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = c4 + e;
          const float t = k < r ? v[e] : (k == r && r < m ? diag(v[e]) : 0.0f);
          dst[up_off(k, mp) + r - 4 * (k >> 2)] = t;
        }
      });
}

}  // namespace wf
