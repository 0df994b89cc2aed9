// The whole backward of the variance quadratic form, both gradients from one
// C, for Hopper (sm_90a).
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, _qf_bwd_rule (:636), both of its pallas_calls: the
//   W half (:648, _qf_dwt_body :529) and the A half (:667, _qf_da_body :553).
//
//   C[s, g]        = A[s]^T W[s, g]                        (N x M)
//   E[s, g, n, k]  = 2 vbar[s, g, n] C[s, g, n, k]
//   dW[s, g, m, k] = sum_n A[s, m, n] E[s, g, n, k]        for k <= m, 0 above
//   dA[s, m, n]    = sum_g sum_{k <= m} W[s, g, m, k] E[s, g, n, k]
//   A (S, M, N), W (S, G, M, M) lower-triangular, vbar (S, G, N) -> dA (S, M, N),
//   dW (S, G, M, M), all float32.  Only W's lower triangle is read and only
//   dW's is computed (csrc/quadform_diag_dw.cu says why that suffices).
//
// Bound on the H100.  Per (g, n) each of the three products is M (M + 1) / 2
// FMAs of the triangle.  C takes three TF32 pieces an operand (six TF32
// products per FMA: its sums cancel on the path, csrc/qf_mma.cuh), the two
// products after it 3xTF32 (three each): 12 TF32 products per FMA of the
// triangle, against 18 for the pair 6b + 6c, which each compute C.  At ECoG
// width (G = 3003, M = 100, N = 512) that is 0.376 ms on the dense TF32 rate
// (495 TFLOP/s), against 2 x 0.282 for the pair; 1.50 ms at M = 200.  W's
// triangle and dW's are 60 MB each at M = 100: 0.036 ms at 3.35 TB/s.
//
// Design.  A block owns a tile of TN columns of N and a chunk of groups, and
// walks each group in k-panels of 32 columns [k0, k0 + 32), all three products
// of a panel reading one slab W_g[k0:M, k0:k0+32].
//   - Operands split once.  A's tile is split into its three TF32 pieces when
//     it is staged, once a block (A is the same for every group); each slab
//     is loaded into registers a panel ahead and split into the other of two
//     slab buffers, once a (group, panel); E's two pieces where E is formed.
//     Shared memory holds the pieces, so no warp splits a fragment; the
//     fragment layouts pair adjacent columns (the k order inside an m16n8k8
//     is free), so most fragments load 8 bytes a lane.
//   - (a) C[n, panel] = sum_{r >= k0} A[r, n] W[r, panel]: one 16 (n) x 8 (k)
//     tile a warp (4 x TN / 16 warps), over the slab's rows from the first its
//     columns meet in the triangle, unrolled by two k-steps; each k-step's six
//     piece products run as two chains.  E = 2 vbar C is split and stored.
//   - (c) dW[m >= k0, panel] = A[m, tile] E[tile, panel]: 16 rows x 16
//     columns a unit (two chains, A's fragment shared), at most one a warp at
//     M = 100, each sent to the block of the cluster that sums its rows.
//   - (d) dA[m >= k0, tile] += W[m, panel] E[tile, panel]^T: each warp owns
//     dA's row tiles kt, kt + 4, ... of one n-tile in registers across the
//     chunk, so dA needs no exchange inside the block.
//   Each k-step's piece products start from zero and are added to the
//   float32 accumulator by the CUDA cores (csrc/qf_mma.cuh: the tensor core's
//   own accumulation erred 4-20x the plain version over long sums).
// Reductions, deterministic, no atomics:
//   - dW's panel is summed over the N tiles that share a group in a thread-
//     block cluster along N (up to 8 tiles, `kMaxCluster`): block `rank` of
//     the cluster sums rows rank, rank + cs, ..., which every block sends it
//     (distributed shared memory), over the blocks in rank order, and writes
//     them with dW's zeros above the diagonal.  The cluster barrier's arrive
//     ends a panel and its wait follows the next panel's (a), so (a) hides
//     its latency; the sum of a panel overlaps the next panel's products
//     (two receive buffers where they fit).  N beyond 8 tiles (N > 512 at
//     TN = 64) takes several clusters ("supers") a group, whose panels go to
//     a (supers, S, G, M, M) buffer summed in order by a second pass; at
//     ECoG's N = 512 and a rank's N = 256 one cluster holds N.
//     Measured cost at ECoG width: the same kernel with the cluster barriers
//     and the sends to other blocks taken out (its dW wrong) ran 0.63 of
//     4.32 ms faster.
//   - dA's partial sums, (S, chunks, M, N), are summed in order by the same
//     second pass, as 6c sums its chunks.
// Grid from the shape: TN = 64 (M <= 112) or 32 (M <= 208: shared memory);
// the cluster the largest power of two up to 8 N tiles that the card
// schedules; the chunks of groups so that the clusters of a launch fill the
// card once (`cudaOccupancyMaxActiveClusters`), at most one chunk a group.
// W is read in its (G, M, M) layout.
//
// Measured on the H100 (PERF.md): the work is bound neither by the tensor
// cores nor by shared memory's bandwidth but by the panels' short phases:
// the (a) loop alone reaches 0.30 m16n8k8 a clock an SM (half of mma.sync's
// TF32 rate; 0.40 with two tiles a warp), the kernel 0.12.  Designs tried
// and slower at ECoG width: 8 warps with two and four tiles a warp, the
// rows of (a) split over four warps, 2 blocks an SM at TN = 32, clusters of
// 4 and 2, a stage running the next panel's (a) beside (c) and (d), and (a)
// by `wgmma` from a K-major slab.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kKP = 32;          // columns k per panel
constexpr int kKT = kKP / 8;     // its 8-column tiles: the warps of an n-tile
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSumThreads = 256;

__host__ __device__ constexpr int rows16(int m) { return 16 * ((m + 15) / 16); }

// E's layout in shared memory: row n of 32 columns k, column k moved to
// k ^ 8 ((n >> 1) & 3).  Its writers (from C's fragments: rows 2q and
// 2q + 1, columns 2t, 2t + 1) and its readers (dW's B operand: rows 2t and
// 2t + 1, column q) are then both free of bank conflicts; pairs of columns
// stay adjacent.
__device__ __forceinline__ int eswz(int n, int k) { return k ^ (((n >> 1) & 3) << 3); }

template <int TN, int MT, int NX, int WB>
struct Shape {
  static constexpr int kNT = TN / 16;           // 16-column n-tiles of the N tile
  static constexpr int kWarps = kKT * kNT;      // one (n-tile, k-tile) of C a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMpad = 16 * MT;         // rows of A and of a slab, at most
  static constexpr int kA = kMpad * TN;         // a plane of A's pieces
  static constexpr int kW = kMpad * kKP;        // a plane of a slab's pieces
  static constexpr int kE = TN * kKP;           // a plane of E's pieces
  // a receive buffer of dW's panel: from each of cs blocks, ceil(mpad / cs)
  // rows of kRecvRow floats (32 and 8 of padding: the writers' rows q and
  // q + 8 of a fragment fall on other banks)
  static constexpr int kRecvRow = kKP + 8;
  static constexpr int kRecv = (kMpad + kMaxCluster) * kRecvRow;
  static constexpr int kChunks = (kMpad * (kKP / 4) + kThreads - 1) / kThreads;  // a slab's 16 B a thread
  static constexpr int kRowTiles = (MT + kKT - 1) / kKT;  // dA's 16-row tiles a warp owns
  // A's three planes, WB slabs of three, E's two, NX receive buffers
  static constexpr size_t kSmem =
      sizeof(float) * (3 * (size_t)kA + 3 * WB * (size_t)kW + 2 * (size_t)kE + NX * (size_t)kRecv);
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TN, int MT, int NX, int WB>
__global__ void __launch_bounds__(Shape<TN, MT, NX, WB>::kThreads, 1)
    quadform_diag_bwd_kernel(const float* __restrict__ A, const float* __restrict__ W,
                             const float* __restrict__ vbar, float* __restrict__ dA_part,
                             float* __restrict__ dW_out, int m, int n, int g, int chunks,
                             int vec_w) {
  using L = Shape<TN, MT, NX, WB>;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  uint32_t* Ap = reinterpret_cast<uint32_t*>(smem4);  // 3 x mpad x TN: A's pieces, zero beyond m, n
  uint32_t* Wp = Ap + 3 * L::kA;                      // WB x 3 x rpad x 32: slabs' pieces
  uint32_t* Ep = Wp + 3 * WB * L::kW;                 // 2 x TN x 32: E's pieces
  float* recv = reinterpret_cast<float*>(Ep + 2 * L::kE);  // NX x (cs x rows_per) x 32

  const int n0 = blockIdx.x * TN;
  const int super = blockIdx.x / cs;
  const int chunk = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, t = lane & 3;
  const int kt = warp % kKT, nt = warp / kKT;  // C's tile of this warp; its dA rows kt + 4 i
  const int sq = ((q & 3) << 3) | (q & 4);     // qf::swz's move of a row r with r % 8 = q
  const int mpad = rows16(m);
  const int rows_per = (mpad + cs - 1) / cs;   // rows of a panel each block of the cluster sums
  const int g_lo = (int)((long long)chunk * g / chunks);
  const int g_hi = (int)((long long)(chunk + 1) * g / chunks);
  const int panels = (m + kKP - 1) / kKP;
  const int total = (g_hi - g_lo) * panels;  // (group, panel) pairs, group-major

  // A's tile, split once
  {
    const float* As = A + (size_t)s * m * n;
    for (int i = threadIdx.x; i < mpad * TN; i += L::kThreads) {
      const int r = i / TN, c = i % TN;
      uint32_t v[3][1];
      qf::split<3, 1>(r < m && n0 + c < n ? As[(size_t)r * n + n0 + c] : 0.0f, v, 0);
      const int o = r * TN + qf::swz(r, c);
      Ap[o] = v[0][0];
      Ap[L::kA + o] = v[1][0];
      Ap[2 * L::kA + o] = v[2][0];
    }
  }

  // A slab W_g[k0 + r, k0 + kk] (lower triangle, zero beyond m) is loaded
  // into registers a stage ahead, 16 bytes a piece, then split into its
  // pieces by the thread that loaded it.
  float4 pre[L::kChunks];
  auto load_slab = [&](int it) {
    const int gi = g_lo + it / panels, k0 = (it % panels) * kKP;
    const int rows = m - k0, rpad = rows16(rows);
    const float* Wg = W + ((size_t)s * g + gi) * m * m + (size_t)k0 * m + k0;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      const int i = threadIdx.x + c * L::kThreads;
      const int r = i / (kKP / 4), col = 4 * (i % (kKP / 4));
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int keep = i < rpad * (kKP / 4) && r < rows ? min(4, min(rows - col, r - col + 1)) : 0;
      const float* src = Wg + (size_t)r * m + col;
      if (keep == 4 && vec_w) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else if (keep > 0) {
        x.x = __ldg(src);
        if (keep > 1) x.y = __ldg(src + 1);
        if (keep > 2) x.z = __ldg(src + 2);
        if (keep > 3) x.w = __ldg(src + 3);
      }
      pre[c] = x;
    }
  };
  auto split_slab = [&](uint32_t* dst, int it) {
    const int rpad = rows16(m - (it % panels) * kKP);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      const int i = threadIdx.x + c * L::kThreads;
      if (i >= rpad * (kKP / 4)) continue;
      const int r = i / (kKP / 4), col = 4 * (i % (kKP / 4));
      const int o = r * kKP + qf::swz(r, col);
      uint32_t v[3][4];
      qf::split<3, 4>(pre[c].x, v, 0);
      qf::split<3, 4>(pre[c].y, v, 1);
      qf::split<3, 4>(pre[c].z, v, 2);
      qf::split<3, 4>(pre[c].w, v, 3);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint4*>(dst + p * L::kW + o) = make_uint4(v[p][0], v[p][1], v[p][2], v[p][3]);
    }
  };
  // dW's panel of (group, panel) `it`, this block's rows rank, rank + cs, ...:
  // the cluster's blocks' parts summed in rank order; zeros above the diagonal.
  auto reduce = [&](int it) {
    const int gi = g_lo + it / panels, k0 = (it % panels) * kKP;
    const float* rb = recv + (it % NX) * L::kRecv;
    float* dst = dW_out + (((size_t)super * gridDim.z + s) * g + gi) * m * m;
    const int cols = min(kKP, m - k0);
    const int mine = (m - rank + cs - 1) / cs;
    for (int e = threadIdx.x; e < mine * kKP; e += L::kThreads) {
      const int lr = e / kKP, kk = e % kKP, row = rank + cs * lr;
      if (kk >= cols) continue;
      float v = 0.0f;
      if (k0 + kk <= row) {
        const float* from = rb + lr * L::kRecvRow + kk;
        float x[kMaxCluster];
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          x[j] = j < cs ? from[j * rows_per * L::kRecvRow] : 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j) v += x[j];
      }
      dst[(size_t)row * m + k0 + kk] = v;
    }
  };

  float acc[L::kRowTiles][2][4];  // dA[16 (kt + 4 i).., this n-tile's even / odd columns]
#pragma unroll
  for (int i = 0; i < L::kRowTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;

  if (total > 0) {
    load_slab(0);
    split_slab(Wp, 0);
  }
  if (total > 1) load_slab(1);
  __syncthreads();  // A's and the first slab's pieces

  // Row i of this warp's C tile is column nl + 2 i (i < 8) or nl + 2 (i - 8) + 1
  // of the N tile, so A's fragment pairs adjacent columns.
  const int nl = 16 * nt + 2 * q;
  // vbar's two columns of the lane, loaded a stage ahead
  auto load_v = [&](int it, float& v0, float& v1) {
    const float* vg = vbar + ((size_t)s * g + g_lo + it / panels) * n + n0 + nl;
    v0 = n0 + nl < n ? 2.0f * __ldg(vg) : 0.0f;
    v1 = n0 + nl + 1 < n ? 2.0f * __ldg(vg + 1) : 0.0f;
  };
  float v0n = 0.0f, v1n = 0.0f;
  if (total > 0) load_v(0, v0n, v1n);
  for (int it = 0; it < total; ++it) {
    const int k0 = (it % panels) * kKP;
    const int rows = m - k0, rpad = rows16(rows);
    const float v0 = v0n, v1 = v1n;
    if (it + 1 < total) load_v(it + 1, v0n, v1n);
    const uint32_t* Wc = Wp + (WB == 2 ? (it & 1) * 3 * L::kW : 0);  // this slab's pieces
    if (WB == 1 && it > 0) {
      split_slab(Wp, it);
      if (it + 1 < total) load_slab(it + 1);
      __syncthreads();
    }

    // (a) C[nl.., 8 kt..] = sum_{r >= 8 kt} A[k0 + r, nl..] W[k0 + r, k0 + 8 kt..],
    // over the k-steps of 8 rows that hold rows of W.  Rows k0 + r0 + t and
    // + 4 (r0 % 8 = 0) move by 8 t and 8 t + 4 in qf::swz.  The six piece
    // products run as two chains from zero.
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (8 * kt < rows) {
      const uint32_t* pa = Ap + (k0 + 8 * kt + t) * TN;
      const uint32_t* pb = Wc + (8 * kt + t) * kKP;
      const int ca0 = nl ^ (8 * t), ca1 = nl ^ (8 * t + 4);
      const int cb0 = (8 * kt + q) ^ (8 * t), cb1 = (8 * kt + q) ^ (8 * t + 4);
#pragma unroll 2
      for (int r0 = 8 * kt; r0 < rows; r0 += 8, pa += 8 * TN, pb += 8 * kKP) {
        uint32_t a[3][4], b[3][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint2 lo = *reinterpret_cast<const uint2*>(pa + p * L::kA + ca0);
          const uint2 hi = *reinterpret_cast<const uint2*>(pa + p * L::kA + 4 * TN + ca1);
          a[p][0] = lo.x;
          a[p][1] = lo.y;
          a[p][2] = hi.x;
          a[p][3] = hi.y;
          b[p][0] = pb[p * L::kW + cb0];
          b[p][1] = pb[p * L::kW + 4 * kKP + cb1];
        }
        float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        qf::mma_tf32(t1, a[2], b[0]);
        qf::mma_tf32(t2, a[1], b[0]);
        qf::mma_tf32(t1, a[1], b[1]);
        qf::mma_tf32(t2, a[0], b[1]);
        qf::mma_tf32(t1, a[0], b[2]);
        qf::mma_tf32(t2, a[0], b[0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] += t1[e] + t2[e];
      }
    }
    // E = 2 vbar C, split, to shared memory (rows nl and nl + 1)
    {
      uint32_t e[2][4];
      qf::split<2, 4>(v0 * c[0], e, 0);
      qf::split<2, 4>(v0 * c[1], e, 1);
      qf::split<2, 4>(v1 * c[2], e, 2);
      qf::split<2, 4>(v1 * c[3], e, 3);
      const int kk = 8 * kt + 2 * t;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        *reinterpret_cast<uint2*>(Ep + p * L::kE + nl * kKP + eswz(nl, kk)) =
            make_uint2(e[p][0], e[p][1]);
        *reinterpret_cast<uint2*>(Ep + p * L::kE + (nl + 1) * kKP + eswz(nl + 1, kk)) =
            make_uint2(e[p][2], e[p][3]);
      }
    }
    __syncthreads();  // E complete
    if (it > 0) {
      // Every block's part of the last panel has landed here, and every
      // block has summed the panel before it, so its buffer is free.  The
      // barrier's arrive ended the last stage: (a) hid its latency.
      cluster_wait();
      reduce(it - 1);
      if (NX == 1) {  // one buffer: every block's sum of the last panel is done
        cluster_arrive();
        cluster_wait();
      }
    }

    // (c) dW[k0 + 16 j + r, k0 + 16 h + kk] = sum_n A[k0 + 16 j + r, n] E[n, 16 h + kk]
    // for this N tile, sent to the block of the cluster that sums row
    // k0 + 16 j + r.  MMA k index t is column nk + 2t of the tile, t + 4
    // column nk + 2t + 1.  The unit (0, 1) lies above the diagonal.
    {
      float* rb = recv + (it % NX) * L::kRecv;
      const int units = 2 * (rpad / 16);
      for (int u = warp; u < units; u += L::kWarps) {
        const int j = u >> 1, h = u & 1;
        if (j == 0 && h == 1) continue;
        float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        const int ra = k0 + 16 * j + q;
        const uint32_t* pa = Ap + ra * TN;
#pragma unroll
        for (int nk = 0; nk < TN; nk += 8) {
          qf::FragA<2> a;
          const int ca = (nk + 2 * t) ^ sq;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint2 lo = *reinterpret_cast<const uint2*>(pa + p * L::kA + ca);
            const uint2 hi = *reinterpret_cast<const uint2*>(pa + p * L::kA + 8 * TN + ca);
            a.v[p][0] = lo.x;
            a.v[p][2] = lo.y;
            a.v[p][1] = hi.x;
            a.v[p][3] = hi.y;
          }
          const uint32_t* pe = Ep + (nk + 2 * t) * kKP;  // rows nk + 2t, + 1: eswz moves by 8 t
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int kc = (16 * h + 8 * x + q) ^ (8 * t);
            qf::FragB<2> b;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              b.v[p][0] = pe[p * L::kE + kc];
              b.v[p][1] = pe[p * L::kE + kKP + kc];
            }
            qf::mma_split<2>(d[x], a, b);
          }
        }
        // rows ra and ra + 8 go to the same block (cs divides 8)
        float* to = cluster.map_shared_rank(rb, ra % cs);
        const int r0 = rank * rows_per + ra / cs, r1 = rank * rows_per + (ra + 8) / cs;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = 16 * h + 8 * x + 2 * t;
          *reinterpret_cast<float2*>(to + r0 * L::kRecvRow + col) = make_float2(d[x][0], d[x][1]);
          *reinterpret_cast<float2*>(to + r1 * L::kRecvRow + col) = make_float2(d[x][2], d[x][3]);
        }
      }
    }

    // (d) dA[m, n] += sum_{k in the panel} W[m, k] E[n, k] for this warp's
    // rows 16 (kt + 4 i).. and columns 16 nt + 2 j + hh (hh the accumulator),
    // MMA k index t column 8 ks + 2t, t + 4 column 8 ks + 2t + 1.
    {
      const int mt_lo = k0 >> 4;
#pragma unroll
      for (int ks = 0; ks < kKT; ++ks) {
        if (8 * ks >= rows) break;
        qf::FragB<2> b[2];
        const int kc = (8 * ks + 2 * t) ^ ((q & 3) << 3);  // eswz of rows 16 nt + 2q + hh
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint2 x = *reinterpret_cast<const uint2*>(Ep + p * L::kE + (nl + hh) * kKP + kc);
            b[hh].v[p][0] = x.x;
            b[hh].v[p][1] = x.y;
          }
#pragma unroll
        for (int i = 0; i < L::kRowTiles; ++i) {
          const int mt = kt + kKT * i;
          const int r = 16 * mt - k0;  // the tile's first slab row
          if (mt < MT && mt >= mt_lo && 16 * mt < m && 8 * ks <= r + 15) {
            qf::FragA<2> a;
            const uint32_t* pw = Wc + (r + q) * kKP + ((8 * ks + 2 * t) ^ sq);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const uint2 lo = *reinterpret_cast<const uint2*>(pw + p * L::kW);
              const uint2 hi = *reinterpret_cast<const uint2*>(pw + p * L::kW + 8 * kKP);
              a.v[p][0] = lo.x;
              a.v[p][2] = lo.y;
              a.v[p][1] = hi.x;
              a.v[p][3] = hi.y;
            }
            qf::mma_split<2>(acc[i][0], a, b[0]);
            qf::mma_split<2>(acc[i][1], a, b[1]);
          }
        }
      }
    }

    // the next slab's pieces into the other buffer, the one after it loaded
    if (WB == 2 && it + 1 < total) {
      split_slab(Wp + ((it + 1) & 1) * 3 * L::kW, it + 1);
      if (it + 2 < total) load_slab(it + 2);
    }
    cluster_arrive();  // this block's parts of the panel sent
    __syncthreads();   // E and the slab read; the next slab's pieces
  }
  if (total > 0) {
    cluster_wait();
    reduce(total - 1);
  }

  // this warp's dA partial, slot `chunk`: row q of a tile holds columns
  // 4t .. 4t + 3 of the n-tile as (even[0], odd[0], even[1], odd[1])
  float* P = dA_part + ((size_t)s * chunks + chunk) * m * n;
  const int nc = n0 + 16 * nt + 4 * t;
#pragma unroll
  for (int i = 0; i < L::kRowTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (kt + kKT * i) + q + 8 * h;
      if (row >= m) continue;
      const float vals[4] = {acc[i][0][2 * h], acc[i][1][2 * h], acc[i][0][2 * h + 1],
                             acc[i][1][2 * h + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nc + e < n) P[(size_t)row * n + nc + e] = vals[e];
    }
  }
}

// out[b, i] = sum over c = 0, 1, ... of part[b, c, i], in that order.
__global__ void quadform_diag_bwd_sum(const float* __restrict__ part, float* __restrict__ out,
                                      int parts, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float* p = part + (size_t)blockIdx.y * parts * count + i;
  float v = 0.0f;
  for (int c = 0; c < parts; ++c) v += p[(size_t)c * count];
  out[(size_t)blockIdx.y * count + i] = v;
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, int, int, int,
                        int, int);
struct Variant {
  int tn, mt, threads;
  size_t smem;
  Kernel kernel;
};
template <int TN, int MT, int NX, int WB>
Variant variant_of() {
  using L = Shape<TN, MT, NX, WB>;
  return {TN, MT, L::kThreads, L::kSmem, quadform_diag_bwd_kernel<TN, MT, NX, WB>};
}
// (TN, MT, NX, WB): 16 warps at M <= 112, two receive buffers and two slabs;
// at M <= 208 8 warps on half the N tile, one of each (shared memory)
const Variant kVariants[] = {variant_of<64, 7, 2, 2>(), variant_of<32, 13, 1, 1>()};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

bool fits(const Variant& v, int m, int optin) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, v.kernel) != cudaSuccess) return false;
  return rows16(m) <= 16 * v.mt && v.smem + attr.sharedSizeBytes <= (size_t)optin &&
         v.threads <= attr.maxThreadsPerBlock;
}

// The variant the launch takes for inducing size m (the first that fits), or -1.
int variant(int m) {
  const int optin = optin_bytes();
  if (optin < 0) return -1;
  for (int i = 0; i < kNumVariants; ++i)
    if (fits(kVariants[i], m, optin)) return i;
  return -1;
}

cudaLaunchConfig_t config(const Variant& v, dim3 grid, int cs, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(v.threads, 1, 1);
  cfg.dynamicSmemBytes = v.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cs blocks of variant vi that the current device holds at once
// (0 if none), queried once a (device, variant, size).
int active_clusters(int vi, int cs) {
  constexpr int kDevices = 16;
  static int cache[kDevices][kNumVariants][4];
  static bool filled[kDevices][kNumVariants][4];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const int ci = cs == 1 ? 0 : cs == 2 ? 1 : cs == 4 ? 2 : 3;
  if (dev < kDevices && filled[dev][vi][ci]) return cache[dev][vi][ci];
  const Variant& v = kVariants[vi];
  int num = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(v, dim3(cs, 1, 1), cs, nullptr, &attr);
  if (cudaFuncSetAttribute(v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&num, (const void*)v.kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear: a size the card refuses reads as none
    num = 0;
  }
  if (dev < kDevices) {
    cache[dev][vi][ci] = num;
    filled[dev][vi][ci] = true;
  }
  return num;
}

// How a launch at (s, g, m, n) is cut, from the shape and the card alone.
struct Plan {
  int vi, cs, supers, chunks;
};

bool plan(int s, int g, int m, int n, Plan* p) {
  p->vi = variant(m);
  if (p->vi < 0 || s < 1 || g < 1 || n < 1) return false;
  const int ntiles = (n + kVariants[p->vi].tn - 1) / kVariants[p->vi].tn;
  int cs = 1;
  while (2 * cs <= ntiles && 2 * cs <= kMaxCluster) cs *= 2;
  int active = 0;
  for (; cs >= 1; cs /= 2)
    if ((active = active_clusters(p->vi, cs)) > 0) break;
  if (active < 1) return false;
  p->cs = cs;
  p->supers = (ntiles + cs - 1) / cs;
  const long long per_chunk = (long long)p->supers * s;  // clusters a chunk of groups takes
  const long long chunks = (active + per_chunk - 1) / per_chunk;
  p->chunks = (int)(chunks < 1 ? 1 : chunks < g ? chunks : g);
  return true;
}

}  // namespace

// Largest inducing size m some variant takes on the current device, or -1 if
// the device cannot be queried.
extern "C" int quadform_diag_bwd_max_m() {
  if (optin_bytes() < 0) return -1;
  int m = 0;
  while (variant(m + 1) >= 0) ++m;
  return m;
}

// Slices of the dA partial buffer (one a chunk of groups) for (s, g, m, n), or
// -1 if the device cannot be queried or takes no variant for m.
extern "C" int quadform_diag_bwd_parts(int s, int g, int m, int n) {
  Plan p;
  return plan(s, g, m, n, &p) ? p.chunks : -1;
}

// Clusters along N a group takes for (s, g, m, n) (above 1, the dW partial
// buffer holds that many), or -1 as above.
extern "C" int quadform_diag_bwd_supers(int s, int g, int m, int n) {
  Plan p;
  return plan(s, g, m, n, &p) ? p.supers : -1;
}

// A (s, m, n), W (s, g, m, m) lower-triangular, vbar (s, g, n); scratch dA_part
// (s, quadform_diag_bwd_parts(...), m, n) and, where quadform_diag_bwd_supers(...)
// is above 1, dW_part (supers, s, g, m, m), else null; dA (s, m, n), dW
// (s, g, m, m): float32, contiguous; m <= quadform_diag_bwd_max_m(), s, g, n
// >= 1.  The fused kernel, then the ordered sums of the partial buffers.
// Returns cudaGetLastError() after the last launch (or the first error).
extern "C" int quadform_diag_bwd_launch(const float* A, const float* W, const float* vbar,
                                        float* dA_part, float* dW_part, float* dA, float* dW,
                                        int s, int g, int m, int n, void* stream) {
  Plan p;
  if (!plan(s, g, m, n, &p)) return (int)cudaErrorInvalidValue;
  if (p.supers > 1 && dW_part == nullptr) return (int)cudaErrorInvalidValue;
  const Variant& v = kVariants[p.vi];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaFuncSetAttribute(v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies of the slab where every row of W starts 16-byte aligned
  const int vec_w = m % 4 == 0 && (uintptr_t)W % 16 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(v, dim3(p.supers * p.cs, p.chunks, s), p.cs, st, &attr);
  err = cudaLaunchKernelEx(&cfg, v.kernel, A, W, vbar, dA_part, p.supers > 1 ? dW_part : dW, m, n,
                           g, p.chunks, vec_w);
  if (err != cudaSuccess) return (int)err;
  const long long mn = (long long)m * n;
  quadform_diag_bwd_sum<<<dim3((unsigned)((mn + kSumThreads - 1) / kSumThreads), s), kSumThreads,
                          0, st>>>(dA_part, dA, p.chunks, mn);
  if (p.supers > 1) {
    const long long count = (long long)s * g * m * m;
    quadform_diag_bwd_sum<<<dim3((unsigned)((count + kSumThreads - 1) / kSumThreads), 1),
                            kSumThreads, 0, st>>>(dW_part, dW, p.supers, count);
  }
  return (int)cudaGetLastError();
}
