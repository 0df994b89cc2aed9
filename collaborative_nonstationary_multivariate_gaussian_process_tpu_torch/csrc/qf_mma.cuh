// Tensor-core building blocks of the quadform backward kernels
// (csrc/quadform_diag_dw.cu and csrc/quadform_diag_da.cu), for Hopper
// (sm_90a): float32 products on `mma.sync.m16n8k8` TF32 by split operands,
// fragment loaders from swizzled shared-memory tiles, and `cp.async`
// staging.
//
// Split products.  A float32 operand x is split into P TF32 pieces, each
// rounded to nearest (ties away from zero, as cvt.rna) to 10 explicit
// mantissa bits: x0 = tf32(x), x1 = tf32(x - x0), x2 = x - x0 - x1 (each
// difference exact in float32, and x2 fits TF32 exactly).  The rounding is
// two integer operations on the bits, at the full integer rate, in place of
// a cvt.rna conversion (every fragment element is split where it is
// loaded).  A product a b is the sum of the piece products a_i b_j with
// i + j < P, the smallest first, each a TF32 product exact in float32.
//   - P = 2 is "3xTF32" (a1 b0 + a0 b1 + a0 b0): x0 + x1 holds x only to
//     about 2^-23 |x| and a1 b1 (~2^-22 |a b|) is dropped, so each product
//     errs by ~2^-22 |a| |b| where a float32 FMA is exact.
//   - P = 3 takes six products (a2 b0 + a1 b1 + a0 b2 + a1 b0 + a0 b1 +
//     a0 b0): the pieces hold x exactly (33 bits >= 24) and what is dropped
//     is ~2^-33 |a b|, so only the float32 sums round.
// Where a sum cancels, |sum| << sum |a b|, 3xTF32's error shows: on the
// path C = A^T W_g does (W = Lp^-1 tril(sqrt) has entries ~100x its
// product's), and there 3xTF32 errs 4-6x more than a float32 einsum while
// P = 3 does not (tests/test_torch_qf_tf32x3.py, on the CPU).  The kernels
// take P = 3 for C and 3xTF32 for the product after it.
//
// Accumulation.  The tensor core adds its products into the accumulator
// it is given, but not as a float32 add rounds: chained across the k-steps
// of a long sum, the kernels erred 4-20x as much as the plain float32
// version on the H100.  So each k-step's piece products start from zero,
// and that step's sum is added to the float32 accumulator by the CUDA cores.
//
// Tiles.  A tile is a row-major array of `width` floats a row (width a
// multiple of 32, so every row starts at bank 0), with the column of element
// (r, c) moved to swz(r, c) = c ^ (8 (r & 3) + (r & 4)).  The fragments of
// m16n8k8 read a tile in one of two patterns, lane = 4 q + t:
//   - K along the rows: element (row0 + t (+4), col0 + q (+8));
//   - K along the columns: element (row0 + q (+8), col0 + t (+4));
// with row0 a multiple of 8 and col0 of 4.  No padded row stride serves
// both (the first needs 8 or 24 floats mod 32, the second an odd multiple
// of 4); the swizzle makes both conflict-free, and it moves aligned groups
// of four columns as a whole, so 16-byte `cp.async` copies land contiguous.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qf {

__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r & 3) << 3) | (r & 4)); }

// x rounded to TF32 (to nearest, ties away from zero), as its bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The operands of one m16n8k8, each split into P TF32 pieces (v[0] the
// largest): A is 16 x 8, B is 8 x 8.
template <int P>
struct FragA {
  static_assert(P == 2 || P == 3, "two or three pieces");
  uint32_t v[P][4];
};
template <int P>
struct FragB {
  uint32_t v[P][2];
};

template <int P, int N>
__device__ __forceinline__ void split(float x, uint32_t (&v)[P][N], int e) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    v[p][e] = p == 2 ? __float_as_uint(x) : tf32(x);  // the third piece is exact
    x -= __uint_as_float(v[p][e]);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: the piece products a_i b_j, i + j < P, the smallest first,
// summed on the tensor core from zero, then added to d in float32.
template <int P>
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA<P>& a, const FragB<P>& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = P - 1; s >= 0; --s)
#pragma unroll
    for (int i = s; i >= 0; --i) mma_tf32(t, a.v[i], b.v[s - i]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ float at(const float* T, int width, int r, int c) {
  return T[r * width + swz(r, c)];
}

// A operand, element (i, k) = T[row0 + k][col0 + i]: K along the rows.
template <int P>
__device__ __forceinline__ void load_a_kr(FragA<P>& f, const float* T, int width, int row0,
                                          int col0, int lane) {
  const int q = lane >> 2, t = lane & 3;
  split(at(T, width, row0 + t, col0 + q), f.v, 0);
  split(at(T, width, row0 + t, col0 + q + 8), f.v, 1);
  split(at(T, width, row0 + t + 4, col0 + q), f.v, 2);
  split(at(T, width, row0 + t + 4, col0 + q + 8), f.v, 3);
}

// A operand, element (i, k) = T[row0 + i][col0 + k]: K along the columns.
template <int P>
__device__ __forceinline__ void load_a_kc(FragA<P>& f, const float* T, int width, int row0,
                                          int col0, int lane) {
  const int q = lane >> 2, t = lane & 3;
  split(at(T, width, row0 + q, col0 + t), f.v, 0);
  split(at(T, width, row0 + q + 8, col0 + t), f.v, 1);
  split(at(T, width, row0 + q, col0 + t + 4), f.v, 2);
  split(at(T, width, row0 + q + 8, col0 + t + 4), f.v, 3);
}

// B operand, element (k, j) = T[row0 + k][col0 + j]: K along the rows.
template <int P>
__device__ __forceinline__ void load_b_kr(FragB<P>& f, const float* T, int width, int row0,
                                          int col0, int lane) {
  const int q = lane >> 2, t = lane & 3;
  split(at(T, width, row0 + t, col0 + q), f.v, 0);
  split(at(T, width, row0 + t + 4, col0 + q), f.v, 1);
}

// C[n, kk] = sum_r A[arow0 + r][n] W[r][kk] for the 16 x 8 tiles (n-tile
// nt, column tile kt) of a TN x 32 block of C, from an A tile (width TN,
// rows arow0 + r) and a slab W (width 32, zero above its diagonal, rows
// padded with zeros to a multiple of 16), r over [8 kt, rows): the rows
// below 8 kt meet only the zeros above the slab's diagonal.  The warps of
// the block split the tiles: warp w takes kt = w % 4 and the n-tiles
// w / 4 + (nwarps / 4) j, so it loads and splits each slab fragment once
// for all of its tiles, which it runs as independent chains.  c[j] is the
// tile of n-tile nt(j) = w / 4 + (nwarps / 4) j while that is < TN / 16.
template <int TN, int P>
__device__ __forceinline__ void panel_c(float (&c)[TN / 16][4], const float* As, int arow0,
                                        const float* Ws, int rows, int warp, int nwarps,
                                        int lane) {
  constexpr int kNT = TN / 16;
  const int kt = warp & 3, step = nwarps >> 2;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll 2
  for (int r0 = 8 * kt; r0 < rows; r0 += 8) {
    FragB<P> b;
    load_b_kr(b, Ws, 32, r0, 8 * kt, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int nt = (warp >> 2) + step * j;
      if (nt < kNT) {
        FragA<P> a;
        load_a_kr(a, As, TN, arow0 + r0, 16 * nt, lane);
        mma_split(c[j], a, b);
      }
    }
  }
}

// ------------------------------------------------------------------ cp.async

// 16 bytes from global to shared; the bytes past src_bytes are zero-filled
// (src_bytes 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// No element is dropped by the triangle test.
constexpr int kNoTriangle = 1 << 29;

// Starts the copy of a (rows_pad x WIDTH) tile T <- src[r * lds + c], kept
// where r < rows, c < cols and c <= r + tri (the lower triangle for tri =
// 0), zero elsewhere; all threads of the block take part.  With `vec`
// (src 16-byte aligned and lds a multiple of 4) 16-byte copies, else 4-byte.
template <int WIDTH>
__device__ __forceinline__ void stage_tile(float* T, const float* src, long long lds, int rows_pad,
                                           int rows, int cols, int tri, bool vec) {
  constexpr int kC4 = WIDTH / 4;
  for (int i = threadIdx.x; i < rows_pad * kC4; i += blockDim.x) {
    const int r = i / kC4, c = 4 * (i % kC4);
    float* dst = T + r * WIDTH + swz(r, c);
    const int keep = r < rows ? max(0, min(4, min(cols - c, r + tri - c + 1))) : 0;
    const float* from = src + (long long)r * lds + c;
    if (vec) {
      cp_async16(dst, keep > 0 ? from : src, 4 * keep);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < keep ? from + e : src, e < keep ? 4 : 0);
    }
  }
}

}  // namespace qf
