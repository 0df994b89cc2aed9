// The backward of the whitened coefficient factors (csrc/whitened_factors.cu),
// for Hopper (sm_90a): the factor parameter's gradient written once, and the
// prior inverse factors' gradients summed over the groups without the
// (G, M, M) broadcast gradient.
//
// Replaces no TPU kernel (the JAX package leaves this to XLA's autodiff).
// With E[s, g] = dW[s, g] + 2 dtrace[s, g] W[s, g] (lower triangle; the
// quadform's backward gives dW's lower triangle, zeros above), and T_g, d_k
// and r_k = sqrt(d_k^2 + jitter) of the forward:
//   dT_g       = sum_s P_s^T E[s, g]                       (lower triangle)
//   dX_g       = dT_g strictly below the diagonal, 0 above it, and on it
//                dT_kk sign(d_k) d_k / r_k + dlogdet_g d_k / r_k^2
//   dP_s       = sum_g E[s, g] T_g^T                       (whole)
// each set's dP with its own groups.  dW, dtrace and dlogdet may each be
// absent (null: no cotangent).  dP is computed whole, as the plain product's
// backward gives it: its strictly upper part reaches the parameters only
// through the rounding of the Cholesky-inverse backward (L^T L^-T = I), but
// at ECoG's nearly flat priors that rounding moves the variances' gradients
// by ~1e-10 in float64, and the lanes that compute it idle otherwise.
//
// Bound on the H100: bytes.  At ECoG (G = 3081, M = 100, S = 1) the lower
// triangles of dW, W and X are read (62 MB each) and dX written whole (123
// MB): 92 us at 3.35 TB/s.  The two products are M^3 / 6 and M^3 / 3 FMAs a
// group (dT's triangle, dP's whole), 3.1 GFLOP, 46 us at 67 TFLOP/s.  The plain composition makes ~23
// passes over (G, M, M) tensors: four slice backwards that zero-fill and
// add, the broadcast gradient of Lp^-1 summed over the groups, the masks'
// and `where`'s backwards.
//
// Design.  A block takes a chunk of groups of one set, and a part of their
// 8-row strips (parts > 1 only where the groups are too few to fill the
// card: strips p + parts t, at least 4 a part).  For each group and draw,
// two phases over packed triangles in shared memory (csrc/whitened.cuh;
// P keeps its own buffer, staged once a draw, where a third triangle fits
// and costs no block an SM: M <= ~168):
//   1. P_s lower-packed and E lower-packed (formed as it is staged): each
//      warp an 8-row strip i0 of dT, each lane a 4-column block, summed
//      over the rows m >= i0 (P's row two broadcast float4s, E's a float4 a
//      lane: 32 FMAs a step).  At the last draw the diagonal's chain is
//      applied and dX written (zeros above the diagonal); with several
//      draws the partial dT waits in dX's rows, read back by the thread
//      that wrote it.
//   2. T^T upper-packed in P's place (T rebuilt from X, written column
//      block by column block so that a warp's transposed writes are
//      consecutive words), with E still there: each warp a strip of dP,
//      each lane a 4-column block (all of them: the lanes right of the
//      diagonal block compute dP's upper part in the same steps), over the
//      columns k <= i0 + 7 (eight broadcast floats of E, a float4 of T^T a
//      lane), added into the block's own slot of a partial buffer (written
//      at the chunk's first group).
// A second kernel sums each set's slots over its chunks in a fixed order
// (four chains, then their sum) and writes dP whole.  No atomics:
// deterministic.  Chunks and parts from the shape and the card: about one
// wave of blocks, three an SM at M <= 128 (the compiler held to 80
// registers, a few spilled: 0.74 ms against 0.93 at two an SM).
// Measured on the H100 at ECoG (PERF.md): 0.74 ms, 8x the byte
// bound; by `clock64` stamps a group's time splits about evenly between
// the stagings (latency) and the two products (issue: a lane's tile is
// zero for up to half a strip's steps).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "whitened.cuh"

namespace {

using namespace wf;

constexpr int kSumThreads = 256;

struct Sets {
  const float* P[2];
  const float* dW[2];   // null: no cotangent
  const float* W[2];
  const float* dtr[2];  // null: no cotangent
  const float* dld[2];  // null: no cotangent
  int n[2];             // groups of each set
  int chunks[2];        // chunks of groups of each set
};

// P_s lower-packed: row r holds P[r][c], c < 4 (r / 4) + 4, zero above the
// diagonal and beyond m.
__device__ void stage_p(float* Pl, const float* P, int m, int mp, bool vec) {
  staged(
      packed_floats(mp) / 4,
      [&](int i) {
        int r, c4;
        lo_chunk(i, r, c4);
        return r < m ? load_row4(P + (size_t)r * m, c4, m, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      },
      [&](int i, float4 x) {
        int r, c4;
        lo_chunk(i, r, c4);
        float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c4 + e > r) v[e] = 0.0f;
        reinterpret_cast<float4*>(Pl)[i] = make_float4(v[0], v[1], v[2], v[3]);
      });
}

// E = dW + 2 dtrace W lower-packed (either term absent where its pointer is
// null), zero above the diagonal and beyond m.
__device__ void stage_e(float* E, const float* dW, const float* W, float two_dtr, int m, int mp,
                        bool vec) {
  staged(
      packed_floats(mp) / 4,
      [&](int i) {
        int r, c4;
        lo_chunk(i, r, c4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < m && dW != nullptr) v = load_row4(dW + (size_t)r * m, c4, m, vec);
        if (r < m && W != nullptr) {
          const float4 w = load_row4(W + (size_t)r * m, c4, m, vec);
          v = make_float4(fmaf(two_dtr, w.x, v.x), fmaf(two_dtr, w.y, v.y), fmaf(two_dtr, w.z, v.z),
                          fmaf(two_dtr, w.w, v.w));
        }
        return v;
      },
      [&](int i, float4 x) {
        int r, c4;
        lo_chunk(i, r, c4);
        float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c4 + e > r) v[e] = 0.0f;
        reinterpret_cast<float4*>(E)[i] = make_float4(v[0], v[1], v[2], v[3]);
      });
}

template <int J>
__global__ void __launch_bounds__(kThreads, J == 1 ? 3 : 1)
    whitened_factors_bwd_kernel(const float* __restrict__ X, Sets sets, float* __restrict__ dX,
                                float* __restrict__ part, int s, int m, float jitter, int parts,
                                int vec, int resident_p) {
  extern __shared__ float4 smem4[];
  const int mp = pad4(m), nb = mp >> 2, strips = (nb + 1) >> 1;
  // P, E, then T^T in a buffer of its own where three fit (`resident_p`: P
  // staged once a draw), else in P's
  float* Pl = reinterpret_cast<float*>(smem4);
  float* E = Pl + packed_floats(mp);
  float* Tt = resident_p ? E + packed_floats(mp) : Pl;
  float* dg = Tt + (resident_p ? packed_floats(mp) : 2 * packed_floats(mp));  // X_g's diagonal, mp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = sets.chunks[0] * parts;
  const int sigma = (int)blockIdx.x < first ? 0 : 1;
  const int local = blockIdx.x - (sigma ? first : 0);
  const int c = local / parts, p = local - c * parts;
  const int n = sets.n[sigma], chunks = sets.chunks[sigma];
  const int ga = (int)((long long)c * n / chunks), gb = (int)((long long)(c + 1) * n / chunks);
  const int count = (strips - p + parts - 1) / parts;  // strips of this part: p + parts i
  const size_t mm = (size_t)m * m;
  float* slot = part + (size_t)blockIdx.x * s * mm;
  int loaded = -1;  // the draw whose P is in shared memory
  const auto regularized = [jitter](float d) {
    const float r = sqrtf(d * d + jitter);
    return d >= 0.0f ? r : -r;
  };

  for (int gl = ga; gl < gb; ++gl) {
    const int gx = sigma ? sets.n[0] + gl : gl;
    const float* Xg = X + (size_t)gx * mm;
    float* dXg = dX + (size_t)gx * mm;
    const float dld = sets.dld[sigma] != nullptr ? sets.dld[sigma][gl] : 0.0f;
    for (int si = 0; si < s; ++si) {
      const size_t item = (size_t)si * n + gl;
      const float two_dtr = sets.dtr[sigma] != nullptr ? 2.0f * sets.dtr[sigma][item] : 0.0f;
      __syncthreads();  // the last phase 2's reads of E and T^T are done
      if (!resident_p || si != loaded) {
        stage_p(Pl, sets.P[sigma] + (size_t)si * mm, m, mp, vec);
        loaded = si;
      }
      stage_e(E, sets.dW[sigma] != nullptr ? sets.dW[sigma] + item * mm : nullptr,
              sets.dtr[sigma] != nullptr ? sets.W[sigma] + item * mm : nullptr, two_dtr, m, mp,
              vec);
      if (si == 0)
        for (int k = threadIdx.x; k < mp; k += kThreads)
          dg[k] = k < m ? __ldg(Xg + (size_t)k * m + k) : 0.0f;
      __syncthreads();

      // 1. dT's 8-row strips (rows i0 .. i0 + 7): sum over the rows m' >= i0 of
      // P[m'][i] E[m'][k]; the part's strips in rising order, the heaviest first
      const auto write_dx = [&](const float(&acc)[J][4][4], int row0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int cb = lane + 32 * j;
          if (cb >= nb) continue;
          float4 prev[4];  // the earlier draws' sums, read before any row is written
#pragma unroll
          for (int r = 0; r < 4; ++r)
            prev[r] = si > 0 && row0 + r < m
                          ? load_row4_rw(dXg + (size_t)(row0 + r) * m, 4 * cb, m, vec)
                          : zero4();
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + r;
            if (row >= m) continue;
            const float pv[4] = {prev[r].x, prev[r].y, prev[r].z, prev[r].w};
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = 4 * cb + q;
              v[q] = acc[j][r][q] + pv[q];
              if (si == s - 1) {  // the last draw: dX from dT
                if (col > row) {
                  v[q] = 0.0f;
                } else if (col == row) {
                  const float d = dg[row], d2j = d * d + jitter, rr = sqrtf(d2j);
                  v[q] = v[q] * ((d >= 0.0f ? d : -d) / rr) + dld * (d / d2j);
                }
              }
            }
            store_row4(dXg + (size_t)row * m, 4 * cb, m, vec, v);
          }
        }
      };
      for (int t = 0;; ++t) {
        const int i = dealt(t, warp, count);
        if (i < 0) break;
        const int rb0 = 2 * (p + parts * i), i0 = 4 * rb0;
        const bool has1 = rb0 + 1 < nb;
        float acc0[J][4][4], acc1[J][4][4];
        zero(acc0);
        zero(acc1);
        for (int mb = rb0; mb < nb; ++mb) {
          const float* row = Pl + lo_off(4 * mb);
          const float* erow = E + lo_off(4 * mb);
          const int len = 4 * mb + 4;
          const bool low = has1 && mb > rb0;  // P's row reaches the strip's second rows
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (4 * mb + q < m) {  // uniform across the warp
              const float4 a0 = *reinterpret_cast<const float4*>(row + q * len + i0);
              const float4 a1 = low ? *reinterpret_cast<const float4*>(row + q * len + i0 + 4) : zero4();
#pragma unroll
              for (int j = 0; j < J; ++j) {  // lanes right of E's row: dT's upper part, unused
                const int cb = lane + 32 * j;
                const float4 b = *reinterpret_cast<const float4*>(erow + q * len + 4 * min(cb, mb));
                outer4(acc0[j], a0, b);
                outer4(acc1[j], a1, b);
              }
            }
          }
        }
        write_dx(acc0, i0);
        write_dx(acc1, i0 + 4);
      }
      __syncthreads();  // phase 1's reads of P are done (where T^T takes its place)
      stage_transposed(Tt, Xg, m, mp, vec, regularized);
      __syncthreads();

      // 2. dP's strips: sum over the columns k <= i0 + 7 of E[i][k] T[m'][k];
      // the part's strips in falling order, the heaviest first
      float* dPs = slot + (size_t)si * mm;
      const auto add_dp = [&](const float(&acc)[J][4][4], int row0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int cb = lane + 32 * j;
          if (cb >= nb) continue;
          float4 prev[4];  // the chunk's earlier groups' sums, read before any row is written
#pragma unroll
          for (int r = 0; r < 4; ++r)
            prev[r] = gl > ga && row0 + r < m
                          ? load_row4_rw(dPs + (size_t)(row0 + r) * m, 4 * cb, m, vec)
                          : zero4();
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (row0 + r >= m) continue;
            const float v[4] = {acc[j][r][0] + prev[r].x, acc[j][r][1] + prev[r].y,
                                acc[j][r][2] + prev[r].z, acc[j][r][3] + prev[r].w};
            store_row4(dPs + (size_t)(row0 + r) * m, 4 * cb, m, vec, v);
          }
        }
      };
      for (int t = 0;; ++t) {
        const int i = dealt(t, warp, count);
        if (i < 0) break;
        const int rb0 = 2 * (p + parts * (count - 1 - i)), i0 = 4 * rb0;
        const bool has1 = rb0 + 1 < nb;
        float acc0[J][4][4], acc1[J][4][4];
        zero(acc0);
        zero(acc1);
        const float* e0 = E + lo_off(i0);      // rows i0 .. i0 + 3, i0 + 4 columns
        const float* e1 = E + lo_off(i0 + 4);  // rows i0 + 4 .. i0 + 7, i0 + 8 columns
        const int l0 = i0 + 4, l1 = i0 + 8;
        const int kend = min(i0 + 8, m);
        for (int kb = 0; 4 * kb < kend; ++kb) {
          const float* trow = Tt + up_off(4 * kb, mp) - 4 * kb;  // indexed by the column
          const int tlen = mp - 4 * kb;
          const bool top = kb <= rb0;  // the strip's first rows still reach column k
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = 4 * kb + q;
            if (k < kend) {
              const float4 a0 = top ? make_float4(e0[k], e0[l0 + k], e0[2 * l0 + k], e0[3 * l0 + k])
                                    : zero4();
              const float4 a1 = has1 ? make_float4(e1[k], e1[l1 + k], e1[2 * l1 + k], e1[3 * l1 + k])
                                     : zero4();
#pragma unroll
              for (int j = 0; j < J; ++j) {  // T^T's row k starts at column block kb
                const int cb = lane + 32 * j, at = max(kb, min(cb, nb - 1));
                const float4 tv = *reinterpret_cast<const float4*>(trow + q * tlen + 4 * at);
                const float4 b = cb == at ? tv : zero4();
                outer4(acc0[j], a0, b);
                outer4(acc1[j], a1, b);
              }
            }
          }
        }
        add_dp(acc0, i0);
        add_dp(acc1, i0 + 4);
      }
    }
  }
}

// dP[sigma][s][row][col] = the sum over the set's chunks of the slot of the
// part that owns the row's strip, in a fixed order.
__global__ void whitened_factors_bwd_sum(const float* __restrict__ part, float* dP0, float* dP1,
                                         int s, int m, int parts, int chunks0, int chunks1) {
  const long long mm = (long long)m * m;
  const long long idx = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (idx >= mm) return;
  const int sigma = blockIdx.z, si = blockIdx.y;
  const int row = (int)(idx / m);
  const int p = (row >> 3) % parts, chunks = sigma ? chunks1 : chunks0;
  const float* at = part + ((sigma ? (long long)chunks0 * parts : 0) + p) * s * mm + si * mm + idx;
  const long long step = (long long)parts * s * mm;
  // four chains over the chunks c = 0, 1, 2, 3 (mod 4), then added in order:
  // a fixed order, four loads in flight
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c = 0;
  for (; c + 3 < chunks; c += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] += at[(c + u) * step];
  for (; c < chunks; ++c) v[c & 3] += at[c * step];
  (sigma ? dP1 : dP0)[si * mm + idx] = (v[0] + v[1]) + (v[2] + v[3]);
}

// Shared memory of a block: two or (`resident_p`) three packed triangles
// and the diagonal.
size_t smem_bytes(int m, bool resident_p) {
  const int mp = pad4(m);
  return ((resident_p ? 3 : 2) * (size_t)packed_floats(mp) + mp) * sizeof(float);
}

bool fits(int m, int optin) {
  return m >= 1 && pad4(m) <= 256 && smem_bytes(m, false) + 1024 <= (size_t)optin;
}

template <int J>
long long resident(int m, bool resident_p) {
  return resident_blocks(whitened_factors_bwd_kernel<J>, smem_bytes(m, resident_p));
}

// How a launch is cut, from the shape and the card: parts of a group's
// strips (several only where the groups leave the card idle, each part at
// least 4 strips) and chunks of each set's groups, about one wave of blocks
// in all.
struct Plan {
  int parts, chunks[2];
  bool resident_p;  // P keeps a buffer of its own
};

bool plan(int s, int n0, int n1, int m, Plan* pl) {
  const int optin = optin_bytes();
  if (optin < 0 || !fits(m, optin) || s < 1 || n0 < 0 || n1 < 0 || n0 + n1 < 1) return false;
  // P resident where its buffer fits and costs no block an SM; the larger
  // layout is queried last, so the kernel's shared-memory limit holds both
  const auto blocks = [m](bool rp) { return pad4(m) <= 128 ? resident<1>(m, rp) : resident<2>(m, rp); };
  const long long two = blocks(false);
  const long long three = smem_bytes(m, true) + 1024 <= (size_t)optin ? blocks(true) : 0;
  pl->resident_p = three >= two;
  const long long res = pl->resident_p ? three : two;
  if (res < 1) return false;
  const long long g = (long long)n0 + n1;
  const int strips = (pad4(m) / 4 + 1) / 2;
  long long parts = res / g;
  const int most = strips / 4 > 1 ? strips / 4 : 1;  // at least 4 strips a part
  parts = parts < 1 ? 1 : parts > most ? most : parts;
  const long long target = res / parts > 1 ? res / parts : 1;
  const int n[2] = {n0, n1};
  for (int k = 0; k < 2; ++k) {
    long long ch = n[k] == 0 ? 0 : (n[k] * target + g - 1) / g;
    pl->chunks[k] = (int)(n[k] == 0 ? 0 : ch < 1 ? 1 : ch > n[k] ? n[k] : ch);
  }
  pl->parts = (int)parts;
  return (long long)pl->parts * (pl->chunks[0] + pl->chunks[1]) <= 0x7fffffff;
}

}  // namespace

// Largest m the kernel takes on the current device, or -1 if the device
// cannot be queried.
extern "C" int whitened_factors_bwd_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits(m + 1, optin)) ++m;
  return m;
}

// Slots of the partial buffer (one a block) for a launch at (s, n0, n1, m),
// or -1 if the device cannot be queried or does not take m.
extern "C" int whitened_factors_bwd_slots(int s, int n0, int n1, int m) {
  Plan pl;
  return plan(s, n0, n1, m, &pl) ? pl.parts * (pl.chunks[0] + pl.chunks[1]) : -1;
}

// X (g, m, m); for each set k (groups [0, g0) and [g0, g)): P_k (s, m, m),
// dW_k and W_k (s, n_k, m, m), dtr_k (s, n_k), dld_k (n_k), each cotangent
// null where absent (W_k is read only with dtr_k); part (slots, s, m, m) with
// slots = whitened_factors_bwd_slots(s, g0, g - g0, m); out: dX (g, m, m),
// dP_k (s, m, m) (dP1 null where g0 == g): float32, contiguous.  The main
// kernel, then the ordered sums of the partial buffer.  Returns
// cudaGetLastError() after the last launch (or the first error).
extern "C" int whitened_factors_bwd_launch(const float* X, const float* P0, const float* P1,
                                           const float* dW0, const float* dW1, const float* W0,
                                           const float* W1, const float* dtr0, const float* dtr1,
                                           const float* dld0, const float* dld1, float* part,
                                           float* dX, float* dP0, float* dP1, int s, int g, int g0,
                                           int m, float jitter, void* stream) {
  if (g0 < 0 || g0 > g) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!plan(s, g0, g - g0, m, &pl)) return (int)cudaErrorInvalidValue;
  const Sets sets{{P0, P1}, {dW0, dW1}, {W0, W1}, {dtr0, dtr1}, {dld0, dld1}, {g0, g - g0},
                  {pl.chunks[0], pl.chunks[1]}};
  bool vec = m % 4 == 0;
  for (const void* ptr : {(const void*)X, (const void*)dX, (const void*)part, (const void*)P0,
                          (const void*)P1, (const void*)dW0, (const void*)dW1, (const void*)W0,
                          (const void*)W1})
    vec = vec && (uintptr_t)ptr % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(m, pl.resident_p);
  const unsigned blocks = (unsigned)(pl.parts * (pl.chunks[0] + pl.chunks[1]));
  if (pad4(m) <= 128)
    whitened_factors_bwd_kernel<1><<<blocks, kThreads, smem, st>>>(X, sets, dX, part, s, m, jitter,
                                                                  pl.parts, vec, pl.resident_p);
  else
    whitened_factors_bwd_kernel<2><<<blocks, kThreads, smem, st>>>(X, sets, dX, part, s, m, jitter,
                                                                  pl.parts, vec, pl.resident_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long mm = (long long)m * m;
  const dim3 grid((unsigned)((mm + kSumThreads - 1) / kSumThreads), s, g0 < g ? 2 : 1);
  whitened_factors_bwd_sum<<<grid, kSumThreads, 0, st>>>(part, dP0, dP1, s, m, pl.parts,
                                                         pl.chunks[0], pl.chunks[1]);
  return (int)cudaGetLastError();
}
