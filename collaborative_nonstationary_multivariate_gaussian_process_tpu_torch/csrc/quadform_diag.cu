// Variance quadratic form of every coefficient group, for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, quadform_diag_pallas -> _qf_forward -> _qf_fwd_body
//   (the forward of ops/linalg._quadform_diag).
//
//   V[s, g, n] = sum_k ( sum_{m >= k} A[s, m, n] W[s, g, m, k] )^2
//   A (S, M, N) float32, W (S, G, M, M) float32 lower-triangular -> V (S, G, N).
//
// W is lower-triangular on the path (W = Lp^-1 @ tril(sqrt), a product of
// lower-triangular factors), so C[k, n] = sum_{m >= k} A[m, n] W[m, k] and
// only the lower triangle of W is read; entries above it are taken as zero
// (the copies zero-fill them, whatever the memory holds).
//
// Bound on the H100: FP32 operations.  Per (g, n) the triangle costs
// M (M + 1) / 2 FMAs for C and M for its squares, M^2 + 3M operations: at
// sample_Y's (8, 3003, 100, 512) 126.7 GFLOP, 1.89 ms at the 67 TFLOP/s
// non-tensor FP32 rate, against ~0.24 GB of W's triangle read, 0.07 ms at
// 3.35 TB/s.  The library route, einsum("smn,sgmk->sgnk") then
// square().sum(-1), does the dense 2 M^2 per (g, n) and writes and reads
// the (S, G, N, M) intermediate.
//
// Why FP32 FMA and not the tensor cores.  C = A^T W is the only product,
// and on the path it cancels: W's entries are ~100x C's.  The backward
// kernels (csrc/qf_mma.cuh) found that 3xTF32 there errs 4-6x the float32
// einsum, so C needs three TF32 pieces an operand, six TF32 products per
// FP32 product: 6 x 0.5 M^2 x 2 flops per (g, n), 760 GFLOP at (8, 3003,
// 100, 512), a bound of 1.5 ms at 495 TFLOP/s dense TF32, at best 1.26x
// below the FP32 bound; the split kernels reached 11-15% of their bound.
// So this kernel stays on the CUDA cores.
//
// Design (not the TPU kernel's block structure):
//   - Grid over (N tile, block of groups, draw s).  A block copies its A
//     tile (all M rows x TN = 16 NT columns) into shared memory once and
//     keeps it there while the lower triangles of its groups' W stream past
//     it, so A is restaged once per block of groups, not once per group.
//     V[g, n] are independent, so N splits over blocks with no reduction,
//     which fills the card at small G.
//   - A warp owns a whole group (or a share of its k-panels, below) and
//     walks its triangle by k-panels of 16 columns, each from its first row
//     k0 to M: every lane does the same row steps, no lane waits on a
//     busier one, and no barrier of the block is crossed after the A tile
//     is in.  The 16 x 16 diagonal block of a panel is multiplied whole
//     (its upper half zero), 15% more FMAs than the triangle at M = 100 and
//     8% at M = 200; a panel's last chunk stops at row M.
//   - W streams through a per-warp double buffer of 16-row x 16-column
//     chunks by `cp.async` (16 bytes where M is a multiple of 4): the next
//     chunk, possibly of the next panel or group, is in flight while this
//     one is multiplied.  Panels of M rows need no more shared memory than
//     one chunk, so M is bounded by the A tile alone (max_m ~800).
//   - Register tile NT columns n x 8 entries k a lane (the warp: 16 lanes
//     along n, 2 along k): a row costs NT / 4 + 2 16-byte shared loads and
//     8 NT FMAs, 10.7 (NT = 4) or 16 (NT = 8) FMAs a load.  A lane's n are
//     4 tn + [0, 4) (and 64 + 4 tn + [0, 4) for NT = 8), so a warp's A load
//     covers 256 contiguous bytes, conflict-free; its W loads are two
//     broadcast addresses.
//   - After a panel the lane squares its C entries and sums them over its
//     8 k; the two k-lanes meet by a shuffle at the end of the group.  Where
//     few groups leave warps idle, WPG = 2, 4 or 8 warps share a group's
//     panels (dealt in snake order, so the long early panels spread) and
//     their sums meet in shared memory behind a named barrier of those
//     warps alone, in a fixed order: the result is deterministic.
//   - C never leaves registers: the (G, N, M) intermediate stays out of
//     device memory.  W is read in its (G, M, M) layout; the TPU kernel's
//     flattened WT operand and 0/1 selector matmuls existed only because
//     Mosaic could not relayout inside a kernel.
// NT = 8 (a 128-column A tile) where one warp per (group, N tile) already
// fills every resident warp slot, else NT = 4 (64 columns): `fills_card`.
// The warps per group and the groups per block are the host's too (`launch`).
//
// On the H100 (700 W) at (8, 3003, 100, 512) see PERF.md (chip_smoke.py):
// about half the FP32 bound.  Of the variants timed against it, 32-row W
// chunks and 4 k a lane in 8-column panels (fewer zeros, but fewer FMAs a
// load) were slower at that shape and were not kept.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = 8;                 // columns k a lane holds
constexpr int kKP = 2 * kKT;           // columns k per panel (two lanes' worth)
constexpr int kR = 16;                 // rows per W chunk
constexpr int kChunk = kR * kKP;       // floats per W chunk
constexpr int kMaxWPG = 8;

__host__ __device__ inline int rows16(int m) { return 16 * ((m + 15) / 16); }
__host__ __device__ inline int panels(int m) { return (m + kKP - 1) / kKP; }

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
__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Panel of slot j of warp wt among wpg warps sharing a group: slots deal
// panels 0, 1, ... in snake order (0..wpg-1, then wpg-1..0, ...).
__device__ __forceinline__ int panel_of(int j, int wt, int wpg) {
  return j * wpg + ((j & 1) ? wpg - 1 - wt : wt);
}

// Shared memory of one block: the A tile (rows16(m) x 16 NT), the warps' W
// double buffers and the two rounds' partial sums of the warps.
size_t smem_bytes(int nt, int m) {
  return ((size_t)rows16(m) * 16 * nt + (size_t)kWarps * 2 * kChunk +
          (size_t)2 * kWarps * 16 * nt) * sizeof(float);
}

// Where a warp is in its stream of W chunks: the round (group of its team),
// the slot (panel) and the chunk's first row.
struct Cursor {
  int round, slot, r0;
};

// acc[i][j] += sum_r A[r, n_i] W[r, k_j] over the rows of one W chunk (the
// lane's NT columns n of the A tile, its kKT columns k of the chunk),
// stopping at row `rows`.
template <int NT>
__device__ __forceinline__ void chunk_fma(float (&acc)[NT][kKT], const float* a_row,
                                          const float* w_row, int rows) {
  constexpr int TN = 16 * NT;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rows) break;
    float av[NT];
    const float4 a0 = *reinterpret_cast<const float4*>(a_row + r * TN);
    av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
    if constexpr (NT == 8) {
      const float4 a1 = *reinterpret_cast<const float4*>(a_row + r * TN + 64);
      av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
    }
    float wv[kKT];
#pragma unroll
    for (int j = 0; j < kKT; j += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w_row + r * kKP + j);
      wv[j] = w4.x, wv[j + 1] = w4.y, wv[j + 2] = w4.z, wv[j + 3] = w4.w;
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < kKT; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    quadform_diag_kernel(const float* __restrict__ A, const float* __restrict__ W,
                         float* __restrict__ V, int m, int n, int g, int groups_per_block,
                         int wpg, int vec_a, int vec_w) {
  constexpr int TN = 16 * NT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int mp = rows16(m);
  float* As = smem;                    // mp x TN, zero beyond column n and row m
  float* Wbuf = As + mp * TN;          // kWarps x 2 chunks of kR x kKP
  float* Red = Wbuf + kWarps * 2 * kChunk;  // 2 rounds x kWarps x TN

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = lane & 15, tk = lane >> 4;
  const int team = warp / wpg, wt = warp % wpg, teams = kWarps / wpg;
  const int n0 = blockIdx.x * TN;
  const int g0 = blockIdx.y * groups_per_block;
  const int s = blockIdx.z;
  const int npan = panels(m);
  const int rounds = groups_per_block / teams;
  const float* Ab = A + (size_t)s * m * n;
  const float* Ws = W + (size_t)s * g * m * m;
  float* Vs = V + (size_t)s * g * n;
  float* wb = Wbuf + warp * 2 * kChunk;

  // the A tile, by every thread
  {
    constexpr int kC4 = TN / 4;
    for (int i = threadIdx.x; i < mp * kC4; i += kThreads) {
      const int r = i / kC4, c = 4 * (i % kC4);
      float* dst = As + r * TN + c;
      const int keep = r < m ? max(0, min(4, n - n0 - c)) : 0;
      const float* from = Ab + (size_t)r * n + n0 + c;
      if (vec_a) {
        cp_async16(dst, keep > 0 ? from : Ab, 4 * keep);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < keep ? from + e : Ab, e < keep ? 4 : 0);
      }
    }
  }

  auto group_of = [&](int round) { return g0 + round * teams + team; };
  auto live = [&](const Cursor& c) { return c.round < rounds && group_of(c.round) < g; };
  auto advance = [&](Cursor c) {
    c.r0 += kR;
    if (c.r0 >= m) {
      ++c.slot;
      int p = panel_of(c.slot, wt, wpg);
      if (p >= npan) {
        ++c.round;
        c.slot = 0;
        p = wt;
      }
      c.r0 = kKP * p;
    }
    return c;
  };
  // the chunk W_g[r0 + r, k0 + c], r < kR, c < kKP, kept where it lies in
  // the lower triangle of the M x M matrix, zero elsewhere; by this warp
  auto stage_w = [&](const Cursor& c, float* dst) {
    const int k0 = kKP * panel_of(c.slot, wt, wpg);
    const float* src = Ws + (size_t)group_of(c.round) * m * m + (size_t)c.r0 * m + k0;
#pragma unroll
    for (int it = 0; it < (kChunk / 4 + 31) / 32; ++it) {
      const int i = lane + 32 * it;
      if (kChunk / 4 % 32 != 0 && i >= kChunk / 4) break;
      const int r = i / (kKP / 4), cc = 4 * (i % (kKP / 4));
      const int row = c.r0 + r, col = k0 + cc;
      const int keep = row < m ? max(0, min(4, min(m - col, row - col + 1))) : 0;
      const float* from = src + (size_t)r * m + cc;
      if (vec_w) {
        cp_async16(dst + r * kKP + cc, keep > 0 ? from : Ws, 4 * keep);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + r * kKP + cc + e, e < keep ? from + e : Ws, e < keep ? 4 : 0);
      }
    }
  };

  Cursor cur{0, 0, kKP * wt};
  if (live(cur)) stage_w(cur, wb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the A tile and every warp's first chunk have landed
  if (!live(cur)) return;  // a team with no group in this block (no barrier follows)

  float acc[NT][kKT];
  float q[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    q[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) acc[i][j] = 0.0f;
  }
  int buf = 0;
  // a lane's columns n of the tile: 4 tn + [0, 4), and 64 more for NT = 8
  const float* a_lane = As + 4 * tn;
  for (;;) {
    const Cursor nxt = advance(cur);
    const bool more = live(nxt);
    if (more) stage_w(nxt, wb + (buf ^ 1) * kChunk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // this chunk has landed, for every lane

    const float* w_row = wb + buf * kChunk + kKT * tk;
    const float* a_row = a_lane + cur.r0 * TN;
    const int rows = m - cur.r0;  // the panel's last chunk stops at row M
    chunk_fma<NT>(acc, a_row, w_row, rows);
    __syncwarp();  // this chunk consumed before the copy after next lands in it
    buf ^= 1;

    const bool panel_end = !more || nxt.slot != cur.slot || nxt.round != cur.round;
    if (panel_end) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          q[i] = fmaf(acc[i][j], acc[i][j], q[i]);
          acc[i][j] = 0.0f;
        }
      }
    }
    if (!more || nxt.round != cur.round) {  // the group's end: its two k-lanes, then its warps
      const int gi = group_of(cur.round);
#pragma unroll
      for (int i = 0; i < NT; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], 16);
      if (wpg > 1) {
        float* red = Red + (cur.round & 1) * kWarps * TN;
        if (tk == 0) {
#pragma unroll
          for (int i = 0; i < NT; ++i) red[warp * TN + 4 * tn + (i & 3) + 64 * (i >> 2)] = q[i];
        }
        team_barrier(1 + team, 32 * wpg);
        if (wt == 0 && tk == 0) {
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            float v = 0.0f;
            for (int w = 0; w < wpg; ++w) v += red[(warp + w) * TN + 4 * tn + (i & 3) + 64 * (i >> 2)];
            q[i] = v;
          }
        }
      }
      if (wt == 0 && tk == 0) {
        float* Vg = Vs + (size_t)gi * n;
#pragma unroll
        for (int h = 0; h < NT / 4; ++h) {
          const int c = n0 + 64 * h + 4 * tn;
          if (vec_a && c + 3 < n) {
            *reinterpret_cast<float4*>(Vg + c) =
                make_float4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < n) Vg[c + e] = q[4 * h + e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) q[i] = 0.0f;
    }
    if (!more) break;
    cur = nxt;
  }
  cp_async_wait<0>();
}

template <int NT>
int fits(int m, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, quadform_diag_kernel<NT>) != cudaSuccess) return 0;
  return smem_bytes(NT, m) + attr.sharedSizeBytes <= (size_t)optin;
}

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// Blocks of the kernel an SM holds, times the SMs; 0 if the device cannot
// be queried.
template <int NT>
long long resident_blocks(int m) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(quadform_diag_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(NT, m)) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quadform_diag_kernel<NT>, kThreads,
                                                    smem_bytes(NT, m)) != cudaSuccess)
    return 0;
  return (long long)sms * per_sm;
}

// Whether one warp per (group, N tile) already gives every resident warp
// slot of the NT-column kernel work.  The wider tile (NT = 8) streams W
// past half as many A tiles and loads fewer bytes a FMA, but halves the
// shares of a small call: on the H100 it was the faster tile at G = 3003
// with N = 512, and the slower one where few groups leave warp slots idle
// (G = 78 at M = 200, G = 6 at N = 2000) or where N = 64 fills half its
// tile.
template <int NT>
bool fills_card(int s, int g, int m, int n) {
  const long long ntiles = (n + 16 * NT - 1) / (16 * NT);
  return (long long)s * g * ntiles >= resident_blocks<NT>(m) * kWarps;
}

template <int NT>
int launch(const float* A, const float* W, float* V, int s, int g, int m, int n,
           cudaStream_t st) {
  const int tn = 16 * NT;
  const long long resident = resident_blocks<NT>(m);  // sets the kernel's shared memory
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  const long long ntiles = (n + tn - 1) / tn;
  // warps per group: the fewest that give every resident warp slot a
  // (group, N tile) share, at most one panel each
  int wpg = 1;
  while (wpg < kMaxWPG && 2 * wpg <= panels(m) &&
         (long long)s * g * ntiles * wpg < resident * kWarps)
    wpg *= 2;
  const int teams = kWarps / wpg;
  // groups per block: as many as leave about four waves of blocks, a whole
  // number of rounds of the block's teams
  const long long want = (4 * resident + ntiles * s - 1) / (ntiles * s);
  long long per_block = (g + want - 1) / want;
  per_block = (per_block + teams - 1) / teams * teams;
  const long long gblocks = (g + per_block - 1) / per_block;
  if (ntiles > 0x7fffffff || gblocks > 65535 || s > 65535) return (int)cudaErrorInvalidValue;
  const int vec_a = n % 4 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)V % 16 == 0;
  const int vec_w = m % 4 == 0 && (uintptr_t)W % 16 == 0;
  const dim3 grid((unsigned)ntiles, (unsigned)gblocks, s);
  quadform_diag_kernel<NT><<<grid, kThreads, smem_bytes(NT, m), st>>>(A, W, V, m, n, g,
                                                                     (int)per_block, wpg, vec_a,
                                                                     vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest inducing size m whose block (64-column A tile) fits the current
// device's opt-in shared memory, or -1 if the device cannot be queried.
extern "C" int quadform_diag_max_m() {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  int m = 0;
  while (fits<4>(m + 1, optin)) ++m;
  return m;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, V (s, g, n): float32,
// contiguous; 1 <= m <= quadform_diag_max_m().  The register tile is 8
// columns n where its 128-column tiles pad N no more than 64-column ones
// do and one warp per (group, N tile) fills the card, else 4.  Returns
// cudaGetLastError() (or the error of the opt-in).
extern "C" int quadform_diag_launch(const float* A, const float* W, float* V, int s, int g,
                                    int m, int n, void* stream) {
  const int optin = optin_bytes();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  if (m < 1 || !fits<4>(m, optin)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (fits<8>(m, optin) && (n + 127) / 128 * 2 == (n + 63) / 64 && fills_card<8>(s, g, m, n))
    return launch<8>(A, W, V, s, g, m, n, st);
  return launch<4>(A, W, V, s, g, m, n, st);
}
