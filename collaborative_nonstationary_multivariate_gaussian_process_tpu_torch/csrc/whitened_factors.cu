// The whitened coefficient factors of one or two sets of coefficient groups
// and their KL pieces, in one pass over the factor parameter, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion
// (ops/linalg.py: tril_regularized, the W = Lp^-1 @ tril(sqrt) product of
// mgp_mean_var_white, kl_gaussian_white's ||W||_F^2 and log-determinant).
// Added because on the card the chain ran as ~4 ATen passes and a batched
// SGEMM over ECoG's 123 MB coefficient factor forward (and ~23 backward,
// csrc/whitened_factors_bwd.cu), each reading and writing whole (G, M, M)
// tensors.
//
//   T_g        = tril(X_g) with diagonal sign(d) sqrt(d^2 + jitter)
//   W[s, g]    = P_s T_g                  (S, G_set, M, M), lower-triangular
//   trace[s, g] = ||W[s, g]||_F^2
//   logdet[g]  = sum_k log sqrt(d_k^2 + jitter)
//   X (G, M, M); groups [0, g0) take P0 (S, M, M), groups [g0, G) P1; each
//   set's W, trace and logdet are its own outputs.  float32 throughout.
//
// What is strictly above X_g's diagonal is masked by a multiply, as the
// plain version's tril_mask does: a non-finite entry there makes T's
// diagonal entry of its column NaN, so W's column and the trace turn
// non-finite as the plain product's do.  W is written whole, zeros above
// its diagonal.
//
// Bound on the H100: bytes.  X is read once (123 MB at ECoG: G = 3081,
// M = 100) and W written once (123 MB a draw): 74 us at 3.35 TB/s.  The
// product of two triangles is M^3 / 6 FMAs a (draw, group), 1.03 GFLOP at
// ECoG, 15 us at the 67 TFLOP/s FP32 rate.  The plain composition moves
// ~11 such tensors (mask multiply, where, the batched product, W * W).
//
// Design.  A block takes a run of (set, draw, group) items.  P_s^T of the
// item's set and draw is staged upper-packed into shared memory when the
// set or draw changes (once a block at S = 1), X_g lower-packed with the
// diagonal regularized (csrc/whitened.cuh).  Then a warp takes an 8-row
// strip of W (two 4-row blocks), a lane a 4-column block of it (two at M >
// 128), over the rows m < i0 + 8 of the two triangles: each step two
// broadcast float4s of P^T's row and one float4 of T's row a lane, 32
// FMAs.  Lanes right of T's row take zeros and write W's zeros.  Strips
// are dealt to warps heaviest first in snake order (their work grows with
// i0).  ||W||^2 and the log-determinant are summed in a fixed order (lanes
// by shuffles, then warps), deterministic.
// Three blocks an SM at M <= 128 (the compiler held to 85 registers).
// Measured on the H100 at ECoG (PERF.md): 0.26 ms, 3.5x the byte
// bound; issue-bound on the CUDA cores, a lane's tile being zero for up to
// half a strip's steps (the triangles), and each item's staging waits on
// memory.  One 4-row block a warp (16 FMAs a step) took twice the cycles.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "whitened.cuh"

namespace {

using namespace wf;

struct Sets {
  const float* P[2];
  float* W[2];
  float* tr[2];
  float* ld[2];
  int n[2];  // groups of each set
};

// X_g lower-packed, what lies above the diagonal multiplied by 0; a
// non-finite entry there (read, packed or not) marks its column with `tag`.
__device__ void stage_t(float* T, int* flag, const float* Xg, int m, int mp, bool vec, int tag) {
  const int c4s = mp >> 2;
  staged(
      mp * c4s,
      [&](int i) {
        const int r = i / c4s;
        return r < m ? load_row4(Xg + (size_t)r * m, 4 * (i - r * c4s), m, vec)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      },
      [&](int i, float4 x) {
        const int r = i / c4s, c4 = 4 * (i - r * c4s);
        float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c4 + e > r) {
            if (!isfinite(v[e])) flag[c4 + e] = tag;
            v[e] *= 0.0f;
          }
        }
        if (c4 <= 4 * (r >> 2))
          *reinterpret_cast<float4*>(T + lo_off(r) + c4) = make_float4(v[0], v[1], v[2], v[3]);
      });
}

// Sum of x over the block, in a fixed order; every thread gets it.
__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // `red` free of its last use
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

template <int J>
__global__ void __launch_bounds__(kThreads, J == 1 ? 3 : 1)
    whitened_factors_kernel(const float* __restrict__ X, Sets sets, int s, int m, float jitter,
                            int per_block, int vec) {
  extern __shared__ float4 smem4[];
  const int mp = pad4(m), nb = mp >> 2;
  float* Pt = reinterpret_cast<float*>(smem4);
  float* T = Pt + packed_floats(mp);
  int* flag = reinterpret_cast<int*>(T + packed_floats(mp));  // mp
  float* red = reinterpret_cast<float*>(flag + mp);           // kWarps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long total = (long long)s * (sets.n[0] + sets.n[1]);
  const long long it0 = (long long)blockIdx.x * per_block;
  const long long it1 = it0 + per_block < total ? it0 + per_block : total;
  for (int i = threadIdx.x; i < mp; i += kThreads) flag[i] = -1;
  long long loaded = -1;  // (set, draw) of the P^T in shared memory
  for (long long it = it0; it < it1; ++it) {
    const long long first = (long long)s * sets.n[0];
    const int sigma = it < first ? 0 : 1;
    const long long rest = it - (sigma ? first : 0);
    const int n = sets.n[sigma];
    const int si = (int)(rest / n), gl = (int)(rest - (long long)si * n);
    const int gx = sigma ? sets.n[0] + gl : gl;
    __syncthreads();  // the last item's reads of T (and P^T) are done
    if (sigma * (long long)s + si != loaded) {
      // P^T upper-packed: row k holds P[r][k], r >= k (P is lower-triangular)
      stage_transposed(Pt, sets.P[sigma] + (size_t)si * m * m, m, mp, vec, [](float v) { return v; });
      loaded = sigma * (long long)s + si;
    }
    const int tag = (int)(it - it0);
    stage_t(T, flag, X + (size_t)gx * m * m, m, mp, vec, tag);
    __syncthreads();
    float logsum = 0.0f;
    for (int k = threadIdx.x; k < m; k += kThreads) {
      float* dk = T + lo_off(k) + k;
      const float d = *dk, r = sqrtf(d * d + jitter);
      *dk = flag[k] == tag ? __int_as_float(0x7fc00000) : (d >= 0.0f ? r : -r);
      logsum += logf(r);
    }
    __syncthreads();

    float* Wg = sets.W[sigma] + ((size_t)si * n + gl) * m * m;
    float sq = 0.0f;
    // 8-row strips (row blocks 2 s and 2 s + 1), the heaviest first: the
    // strip's rows m < 8 s + 8 of P^T and T
    const int strips = (nb + 1) >> 1;
    for (int t = 0;; ++t) {
      const int k = dealt(t, warp, strips);
      if (k < 0) break;
      const int rb0 = 2 * (strips - 1 - k), i0 = 4 * rb0, mend = min(i0 + 8, m);
      const bool has1 = rb0 + 1 < nb;
      float acc0[J][4][4], acc1[J][4][4];
      zero(acc0);
      zero(acc1);
      for (int mb = 0; 4 * mb < mend; ++mb) {
        const float* prow = Pt + up_off(4 * mb, mp) - 4 * mb;  // indexed by the column
        const float* trow = T + lo_off(4 * mb);
        const int plen = mp - 4 * mb, tlen = 4 * mb + 4;
        const bool top = mb <= rb0;  // P^T's row still meets the strip's first rows
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (4 * mb + q < mend) {  // uniform across the warp
            const float4 a0 = top ? *reinterpret_cast<const float4*>(prow + q * plen + i0) : zero4();
            const float4 a1 = has1 ? *reinterpret_cast<const float4*>(prow + q * plen + i0 + 4) : zero4();
#pragma unroll
            for (int j = 0; j < J; ++j) {  // lanes right of T's row read its start, then take 0
              const int cb = lane + 32 * j;
              const float4 tv = *reinterpret_cast<const float4*>(trow + q * tlen + 4 * min(cb, mb));
              const float4 b = cb <= mb ? tv : zero4();
              outer4(acc0[j], a0, b);
              outer4(acc1[j], a1, b);
            }
          }
        }
      }
      auto emit = [&](const float(&acc)[J][4][4], int row0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int cb = lane + 32 * j;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (cb < nb && row0 + r < m) {
#pragma unroll
              for (int q = 0; q < 4; ++q) sq = fmaf(acc[j][r][q], acc[j][r][q], sq);
              store_row4(Wg + (size_t)(row0 + r) * m, 4 * cb, m, vec, acc[j][r]);
            }
          }
        }
      };
      emit(acc0, i0);
      emit(acc1, i0 + 4);
    }
    sq = block_sum(sq, red);
    if (si == 0) logsum = block_sum(logsum, red);
    if (threadIdx.x == 0) {
      sets.tr[sigma][(size_t)si * n + gl] = sq;
      if (si == 0) sets.ld[sigma][gl] = logsum;
    }
  }
}

size_t smem_bytes(int m) {
  const int mp = pad4(m);
  return (2 * (size_t)packed_floats(mp) + kWarps) * sizeof(float) + (size_t)mp * sizeof(int);
}

template <int J>
int launch(const float* X, const Sets& sets, int s, int m, float jitter, cudaStream_t st) {
  const size_t smem = smem_bytes(m);
  const long long resident = resident_blocks(whitened_factors_kernel<J>, smem);
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  const long long total = (long long)s * (sets.n[0] + sets.n[1]);
  const long long blocks = total < resident ? total : resident;
  const long long per_block = (total + blocks - 1) / blocks;
  if (per_block > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bool vec = m % 4 == 0 && (uintptr_t)X % 16 == 0;
  for (int k = 0; k < 2; ++k)
    vec = vec && (sets.n[k] == 0 ||
                  ((uintptr_t)sets.W[k] % 16 == 0 && (uintptr_t)sets.P[k] % 16 == 0));
  const long long grid = (total + per_block - 1) / per_block;
  whitened_factors_kernel<J><<<(unsigned)grid, kThreads, smem, st>>>(X, sets, s, m, jitter,
                                                                     (int)per_block, vec);
  return (int)cudaGetLastError();
}

bool fits(int m, int optin) {
  return m >= 1 && pad4(m) <= 256 && smem_bytes(m) + 1024 <= (size_t)optin;
}

}  // namespace

// Largest m the kernel takes on the current device (its two packed
// triangles in shared memory, at most 256 columns a warp), or -1 if the
// device cannot be queried.
extern "C" int whitened_factors_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits(m + 1, optin)) ++m;
  return m;
}

// X (g, m, m); P0, P1 (s, m, m) lower-triangular; W0 (s, g0, m, m), W1 (s,
// g - g0, m, m), tr0 (s, g0), tr1 (s, g - g0), ld0 (g0), ld1 (g - g0): float32,
// contiguous (the pointers of an empty set are not read); 0 <= g0 <= g,
// 1 <= m <= whitened_factors_max_m().  Returns cudaGetLastError() (or the
// error of the opt-in).
extern "C" int whitened_factors_launch(const float* X, const float* P0, const float* P1, float* W0,
                                       float* W1, float* tr0, float* tr1, float* ld0, float* ld1,
                                       int s, int g, int g0, int m, float jitter, void* stream) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  if (!fits(m, optin) || g0 < 0 || g0 > g || s < 1) return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  const Sets sets{{P0, P1}, {W0, W1}, {tr0, tr1}, {ld0, ld1}, {g0, g - g0}};
  cudaStream_t st = (cudaStream_t)stream;
  return pad4(m) <= 128 ? launch<1>(X, sets, s, m, jitter, st) : launch<2>(X, sets, s, m, jitter, st);
}
