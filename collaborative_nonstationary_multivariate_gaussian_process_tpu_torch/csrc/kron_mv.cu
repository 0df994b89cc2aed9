// Kronecker matvec (B kron K) y = vec((K Y B^T)^T) for Hopper (sm_90a), one
// per chain, without the (N1, M2) intermediate K Y in device memory.
//
// Replaces: collaborative_nonstationary_multivariate_gaussian_process_tpu/
//   ops/pallas_kernels.py, kron_mv_pallas (body :216)
//   (in the port: the forward of ops/kron.kron_mv, and its input gradient).
//
//   out[c, i * N1 + r] = sum_j B[c, i, j] sum_n K[c, r, n] y[c, j * N2 + n]
//   K (C, N1, N2) at strides (sc, sr, sn), B (C, M1, M2), y (C, M2 * N2)
//   task-major; M1, M2 <= 16.
//
// Bound on the H100: bytes.  K is the only large operand (4 C N1 N2 bytes;
// 16 MB at C = 4, N = 1024) and is read once; the FMAs are M2 per element of
// K, ~1 FLOP per byte at M = 2.  So the design keeps many bytes of K in
// flight: 16-byte loads, several per thread before the first is used.
//
// K is read in place in either layout, so the caller copies nothing:
//   rows (sn == 1, K as stored):  a warp takes 4 rows r; each lane streams
//     float4s along n, 8 loads in flight (4 rows x 2), and keeps the M2 sums
//     t[r, j] = sum_n K[r, n] Y[n, j] in registers; a butterfly gives every
//     lane the whole t, contracted with B^T at once;
//   columns (sr == 1, K^T stored, as the eigenvectors' transposes of
//     ops/distributions.mvn_logpdf_kron and the backward's K^T arrive): a
//     block takes 32 columns r; 8 threads cover one stored row n with a
//     float4 each (128 coalesced bytes), 32 such groups split n, each thread
//     keeps its 4 x M2 sums in registers; the groups' partial sums are added
//     in shared memory in a fixed order, then contracted with B^T.
// A chain stride sc = 0 reads one K for all chains (no expanded copy), as do
// B and y with chain stride 0.  y is staged in shared memory once per block,
// 1024 entries of each task at a time, and read from there by every row.
// Shapes whose rows are not 16-byte aligned take the same kernels with
// 4-byte loads.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 16;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;        // entries of each task of y staged at a time
constexpr int kRowsPerWarp = 4;     // rows layout
constexpr int kGroups = 32;         // columns layout: n-groups of a block
constexpr int kLanesPerRow = kThreads / kGroups;  // 8 threads per stored row

// y[c, :, n0:n0 + len] into ys (MM x kChunk), zero for tasks >= m2.
template <int MM>
__device__ void stage_y(float* ys, const float* yc, int m2, int n2, int n0, int len) {
  for (int e = threadIdx.x; e < MM * kChunk; e += blockDim.x) {
    const int j = e / kChunk, n = e % kChunk;
    ys[e] = (j < m2 && n < len) ? yc[(size_t)j * n2 + n0 + n] : 0.0f;
  }
}

template <int MM, int VEC>
__global__ void __launch_bounds__(kThreads)
    kron_rows(const float* __restrict__ K, const float* __restrict__ B,
              const float* __restrict__ y, float* __restrict__ out, int n1, int n2, int m1, int m2,
              long long sc, long long sr, long long b_sc, long long y_sc) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (kThreads / 32) + warp) * kRowsPerWarp;
  const float* Kc = K + c * sc;
  const float* yc = y + c * y_sc;

  float t[kRowsPerWarp][MM];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < MM; ++j) t[r][j] = 0.0f;
  const float* krow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) krow[r] = Kc + (row0 + r < n1 ? row0 + r : 0) * sr;

  for (int n0 = 0; n0 < n2; n0 += kChunk) {
    const int len = min(kChunk, n2 - n0);
    __syncthreads();  // the previous chunk has been read
    stage_y<MM>(ys, yc, m2, n2, n0, len);
    __syncthreads();
    if (row0 < n1) {
      if constexpr (VEC == 4) {
#pragma unroll 2
        for (int n = 4 * lane; n < len; n += 128) {
          float4 k[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            k[r] = __ldg(reinterpret_cast<const float4*>(krow[r] + n0 + n));
#pragma unroll
          for (int j = 0; j < MM; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(ys + j * kChunk + n);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              t[r][j] = fmaf(k[r].x, v.x, fmaf(k[r].y, v.y, fmaf(k[r].z, v.z, fmaf(k[r].w, v.w, t[r][j]))));
          }
        }
      } else {
#pragma unroll 4
        for (int n = lane; n < len; n += 32) {
          float k[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) k[r] = __ldg(krow[r] + n0 + n);
#pragma unroll
          for (int j = 0; j < MM; ++j) {
            const float v = ys[j * kChunk + n];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) t[r][j] = fmaf(k[r], v, t[r][j]);
          }
        }
      }
    }
  }
  if (row0 >= n1) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < MM; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t[r][j] += __shfl_xor_sync(0xffffffffu, t[r][j], off);
  const float* Bc = B + c * b_sc;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (lane < m1 && row0 + r < n1) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MM; ++j)
        if (j < m2) acc = fmaf(Bc[lane * m2 + j], t[r][j], acc);
      out[((size_t)c * m1 + lane) * n1 + row0 + r] = acc;
    }
  }
}

template <int MM, int VEC>
__global__ void __launch_bounds__(kThreads)
    kron_cols(const float* __restrict__ K, const float* __restrict__ B,
              const float* __restrict__ y, float* __restrict__ out, int n1, int n2, int m1, int m2,
              long long sc, long long sn, long long b_sc, long long y_sc) {
  constexpr int RC = kLanesPerRow * VEC;  // columns r of a block
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // MM x kChunk; then kGroups x RC x MM partials
  __shared__ float tsum[RC * MM];
  const int c = blockIdx.y;
  const int tr = threadIdx.x % kLanesPerRow, grp = threadIdx.x / kLanesPerRow;
  const int r0 = blockIdx.x * RC;
  const int rt = r0 + tr * VEC;  // this thread's first column
  const bool active = rt < n1;   // VEC == 4: n1 % 4 == 0, so all VEC columns are in range
  const float* Kc = K + c * sc + (active ? rt : 0);
  const float* yc = y + c * y_sc;

  float acc[VEC][MM];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int j = 0; j < MM; ++j) acc[v][j] = 0.0f;

  for (int n0 = 0; n0 < n2; n0 += kChunk) {
    const int len = min(kChunk, n2 - n0);
    __syncthreads();
    stage_y<MM>(ys, yc, m2, n2, n0, len);
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int n = grp; n < len; n += kGroups) {
        float k[VEC];
        if constexpr (VEC == 4) {
          const float4 k4 = __ldg(reinterpret_cast<const float4*>(Kc + (n0 + n) * sn));
          k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
        } else {
          k[0] = __ldg(Kc + (n0 + n) * sn);
        }
#pragma unroll
        for (int j = 0; j < MM; ++j) {
          const float yv = ys[j * kChunk + n];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v][j] = fmaf(k[v], yv, acc[v][j]);
        }
      }
    }
  }
  __syncthreads();  // ys is reused for the partial sums
  float* part = ys;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int j = 0; j < MM; ++j) part[(grp * RC + tr * VEC + v) * MM + j] = acc[v][j];
  __syncthreads();
  for (int e = threadIdx.x; e < RC * MM; e += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < kGroups; ++g) s += part[g * RC * MM + e];  // fixed order
    tsum[e] = s;
  }
  __syncthreads();
  const float* Bc = B + c * b_sc;
  for (int e = threadIdx.x; e < RC * m1; e += kThreads) {
    const int i = e / RC, r = e % RC;
    if (r0 + r < n1) {
      float s = 0.0f;
      for (int j = 0; j < m2; ++j) s = fmaf(Bc[i * m2 + j], tsum[r * MM + j], s);
      out[((size_t)c * m1 + i) * n1 + r0 + r] = s;
    }
  }
}

template <int MM, int VEC>
int launch_mm(bool rows, const float* K, const float* B, const float* y, float* out, int c, int n1,
              int n2, int m1, int m2, long long sc, long long sr, long long sn, long long b_sc,
              long long y_sc, cudaStream_t st) {
  size_t smem = (size_t)MM * kChunk * sizeof(float);
  if (rows) {
    const auto kern = kron_rows<MM, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per_block = (kThreads / 32) * kRowsPerWarp;
    kern<<<dim3((n1 + per_block - 1) / per_block, c), kThreads, smem, st>>>(K, B, y, out, n1, n2, m1,
                                                                           m2, sc, sr, b_sc, y_sc);
  } else {
    constexpr int RC = kLanesPerRow * VEC;
    const size_t part = (size_t)kGroups * RC * MM * sizeof(float);
    smem = smem > part ? smem : part;
    const auto kern = kron_cols<MM, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((n1 + RC - 1) / RC, c), kThreads, smem, st>>>(K, B, y, out, n1, n2, m1, m2, sc, sn,
                                                             b_sc, y_sc);
  }
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_vec(bool rows, int mm, const float* K, const float* B, const float* y, float* out, int c,
               int n1, int n2, int m1, int m2, long long sc, long long sr, long long sn,
               long long b_sc, long long y_sc, cudaStream_t st) {
  switch (mm) {
    case 2: return launch_mm<2, VEC>(rows, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st);
    case 4: return launch_mm<4, VEC>(rows, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st);
    case 8: return launch_mm<8, VEC>(rows, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st);
    default: return launch_mm<16, VEC>(rows, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st);
  }
}

}  // namespace

// K: element (c, r, n) at K[c * sc + r * sr + n * sn], with sn == 1 (rows)
// or sr == 1 (columns), sc >= 0 (0: one K for all chains); B (m1, m2) per
// chain, contiguous, chain stride b_sc (0: shared); y (m2 * n2) per chain,
// contiguous, chain stride y_sc (0: shared); out (c, m1 * n1) contiguous;
// all float32 on the stream's device; 1 <= m1, m2 <= 16.  Returns
// cudaGetLastError().
extern "C" int kron_mv_launch(const float* K, const float* B, const float* y, float* out, int c,
                              int n1, int n2, int m1, int m2, long long sc, long long sr,
                              long long sn, long long b_sc, long long y_sc, void* stream) {
  if (m1 < 1 || m1 > kMaxM || m2 < 1 || m2 > kMaxM || c < 1 || c > 65535)
    return (int)cudaErrorInvalidValue;
  const bool rows = sn == 1;
  if (!rows && sr != 1) return (int)cudaErrorInvalidValue;
  const int mm = m2 <= 2 ? 2 : m2 <= 4 ? 4 : m2 <= 8 ? 8 : 16;
  // 16-byte loads where every row (or stored row) of every chain starts aligned
  const long long stride = rows ? sr : sn;
  const int inner = rows ? n2 : n1;
  const bool vec = reinterpret_cast<size_t>(K) % 16 == 0 && inner % 4 == 0 && stride % 4 == 0 &&
                   sc % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_vec<4>(rows, mm, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st)
             : launch_vec<1>(rows, mm, K, B, y, out, c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc, st);
}

extern "C" int kron_mv_max_m() { return kMaxM; }
