// Dense dipole interaction matrix I[i, j] = E_j(x_i) . n_i, (N_t, N_s)
// row-major float32, eps 1e-6 by default. Coincident pairs and non-finite
// entries are 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_dipole_imatrix_kernel (via
// dipole_interaction_matrix_pallas). The TPU build itself computes this
// matrix with the XLA fields.dipole_interaction_matrix; the port's greedy
// matrix tier (N <= MATRIX_LIMIT) reads rows of this kernel's output.
//
// What bounds it on an H100: bytes written. At N = 10000 the output is
// 400 MB (0.12 ms at 3.35 TB/s) against ~30 flops per entry (3e9 flops,
// 0.045 ms at 67 TFLOP/s fp32).
//
// Design: a block owns kCols consecutive columns and kRows rows; each
// thread keeps its source j in registers and writes its column of the
// kRows rows, so every row store of a warp is 128 contiguous bytes
// (coalesced along j). The kRows target points are staged in shared memory.
//
// Arithmetic: common.cuh's dipole_pair, the two-divide XLA formula of
// dipole_tpu/ops/fields.py:287-302, so kernel and plain version agree bit
// for bit. The Pallas kernel's single-reciprocal form
// (fields_pallas.py:228-229) differs from both in the last bits.
//
// The mirror-field ("xie") matrix, xie_imatrix below, replaces
// dipole_tpu/ops/fields_pallas.py:_xie_imatrix_kernel (:234-254, via
// xie_interaction_matrix_pallas :298): I (N_t, N_s) or, for the sequential
// xie loop, which reads columns, I^T (N_s, N_t) with the same bits entry for
// entry. It must stay bit-equal to the plain torch version (the xie greedy
// and the replay decide on these bits): common.cuh's xie_terms/xie_value,
// -fmad=false, IEEE sqrtf and divides.
//
// What bounds it on an H100: bytes written, N^2 x 4 B (3.6 GB at 30k:
// 1.075 ms at 3.35 TB/s). But each entry of xie_pair costs ~69 issued
// instructions (one IEEE root and three IEEE divides, each with its check
// for the slow path), 6.2e10 at 30k, ~1.9 ms at the full issue rate: the
// kernel is held by instruction issue, and the design cuts instructions.
//
// Design: on the main paths the targets are the sources (symmetric mode,
// asked for by the caller, not inferred). There a block owns a tile pair
// (I_b, J_b) of kXieTile x kXieTile entries with J_b >= I_b, walking the
// upper triangle of tile pairs as a persistent grid (as many blocks as the
// SMs hold at once). For each pair (i in I_b, j in J_b) it computes the
// shared terms once (xie_terms: one root, two divides) and from them both
// I[i, j] and the mirror entry I[j, i] by the identity of common.cuh's
// xie_value: I and its transpose differ (in 25% of the entries at 1500
// points), but the mirror of pair (i, j) is (nn - (C ntR) nsR) / r3 where
// the entry is (nn - (C nsR) ntR) / r3, bit for bit. The symmetric loop is
// ~93 SASS instructions a pair on its fast path, ~47 an entry: 1.99 ms at
// 30k on an H100 (PERF.md), 64% of the issue rate and half the bound (the
// general mode there, 2.93 ms; the one-row design before it, 3.06). A
// diagonal tile stores only its direct values.
// A thread owns one column j of the tile and kXieRows rows (staged in
// shared memory, read by broadcast) and steps a pointer from row to row,
// so each warp store of the direct tile is 128 contiguous bytes; the
// mirror tile goes through shared memory, transposed, and is stored the
// same way. Every store carries the evict-first hint (st.global.cs): the
// matrix never fits the 50 MB L2. Bulk copies of both tiles from shared
// memory (cp.async.bulk) tied at 30k and lost 5% at 10k (PERF.md). In
// general mode (targets other than the sources) a block owns one output
// tile and computes each entry with xie_pair: the same tiling and stores,
// no mirror. Either layout is the same kernel with the values swapped.
#include "common.cuh"

namespace {

constexpr int kCols = 256;  // threads per block, one column each
constexpr int kRows = 8;    // target rows per block

__global__ void __launch_bounds__(kCols)
imatrix_kernel(const float* __restrict__ tgt, int n_t,
               const float* __restrict__ src, int n_s, float eps,
               float* __restrict__ out) {
  __shared__ float t[6][kRows];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int n_row_blocks = (n_t + kRows - 1) / kRows;
  float sx = 0.f, sy = 0.f, sz = 0.f, px = 0.f, py = 0.f, pz = 0.f;
  if (j < n_s) {
    const float* s = src + 6 * (size_t)j;
    sx = s[0]; sy = s[1]; sz = s[2];
    px = s[3]; py = s[4]; pz = s[5];
  }
  for (int rb = blockIdx.y; rb < n_row_blocks; rb += gridDim.y) {
    const int i0 = rb * kRows;
    if (threadIdx.x < 6 * kRows) {
      const int r = threadIdx.x / 6, c = threadIdx.x % 6;
      t[c][r] = (i0 + r < n_t) ? tgt[6 * (size_t)(i0 + r) + c] : 0.f;
    }
    __syncthreads();
    if (j < n_s) {
      const int rows = min(kRows, n_t - i0);
      for (int r = 0; r < rows; ++r) {
        out[(size_t)(i0 + r) * n_s + j] =
            dipole_pair(sx, sy, sz, px, py, pz, t[0][r], t[1][r], t[2][r],
                        t[3][r], t[4][r], t[5][r], eps);
      }
    }
    __syncthreads();
  }
}

constexpr int kXieTile = 64;                         // a tile: 64 x 64 entries
constexpr int kXieThreads = 256;
constexpr int kXieRows = kXieTile * kXieTile / kXieThreads;  // rows a thread

// Rows [r0, r0 + kXieTile) of pts (n, 6) into shared memory, zeros past n.
__device__ __forceinline__ void stage_rows(const float* __restrict__ pts,
                                           int n, int r0, float4* ra,
                                           float2* rb) {
  if (threadIdx.x < kXieTile) {
    const int r = r0 + threadIdx.x;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) {
#pragma unroll
      for (int c = 0; c < 6; ++c) v[c] = pts[6 * (size_t)r + c];
    }
    ra[threadIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
    rb[threadIdx.x] = make_float2(v[4], v[5]);
  }
}

__device__ __forceinline__ void load_point(const float* __restrict__ pts,
                                           int n, int j, float* q) {
#pragma unroll
  for (int c = 0; c < 6; ++c) q[c] = j < n ? pts[6 * (size_t)j + c] : 0.f;
}

// The next tile pair (bi, bj), bj >= bi, `step` pairs on in row-major order
// of the upper triangle of n_tiles x n_tiles; bi = n_tiles past the end.
__device__ __forceinline__ void advance(int& bi, int& bj, int step,
                                        int n_tiles) {
  bj += step;
  while (bi < n_tiles && bj >= n_tiles) {
    ++bi;
    bj -= n_tiles - bi;
  }
}

// Symmetric mode: out (n, n) is I of pts at pts, or I^T (kTransposed).
// Thread (col, r0) computes pairs (i, j), j = J0 + col the source in
// registers, i = I0 + r for its kXieRows rows r from r0 the targets staged
// in shared memory; the direct value goes to out[i, j], the mirror value to
// out[j, i] through the transposed tile in shared memory. A diagonal tile
// stores only the direct values.
template <bool kTransposed>
__global__ void __launch_bounds__(kXieThreads)
xie_symmetric_kernel(const float* __restrict__ pts, int n, float C,
                     float* __restrict__ out) {
  __shared__ float4 ra[kXieTile];                    // x, y, z, nx
  __shared__ float2 rb[kXieTile];                    // ny, nz
  __shared__ float mirror[kXieTile][kXieTile + 1];   // [j - J0][i - I0]
  const int n_tiles = (n + kXieTile - 1) / kXieTile;
  const int col = threadIdx.x % kXieTile;
  const int r0 = threadIdx.x / kXieTile * kXieRows;
  int bi = 0, bj = 0;
  advance(bi, bj, blockIdx.x, n_tiles);
  for (; bi < n_tiles; advance(bi, bj, gridDim.x, n_tiles)) {
    const int i0 = bi * kXieTile, j0 = bj * kXieTile;
    __syncthreads();                                 // the last pair is spent
    stage_rows(pts, n, i0, ra, rb);
    float q[6];
    load_point(pts, n, j0 + col, q);
    __syncthreads();
    const int r_end = j0 + col < n ? min(r0 + kXieRows, n - i0) : r0;
    float* dst = out + (size_t)(i0 + r0) * n + j0 + col;
#pragma unroll 2
    for (int r = r0; r < r_end; ++r, dst += n) {
      const float4 a = ra[r];
      const float2 b = rb[r];
      const XieTerms m = xie_terms(q[0], q[1], q[2], q[3], q[4], q[5],
                                   a.x, a.y, a.z, a.w, b.x, b.y);
      // I[i, j] from (nsR, ntR), the mirror I[j, i] from (ntR, nsR)
      const float fst = kTransposed ? m.ntR : m.nsR;
      const float snd = kTransposed ? m.nsR : m.ntR;
      __stcs(dst, xie_value(m, fst, snd, C));
      mirror[col][r] = xie_value(m, snd, fst, C);
    }
    if (bi != bj) {
      __syncthreads();
      const int m_end = i0 + col < n ? min(r0 + kXieRows, n - j0) : r0;
      float* mdst = out + (size_t)(j0 + r0) * n + i0 + col;
#pragma unroll 4
      for (int r = r0; r < m_end; ++r, mdst += n) __stcs(mdst, mirror[r][col]);
    }
  }
}

// General mode: out (n_t, n_s) is I of src at tgt, or (kTransposed) I^T
// (n_s, n_t). A block owns output tiles of kXieTile x kXieTile, a thread
// one column (its point in registers) and kXieRows rows (staged).
template <bool kTransposed>
__global__ void __launch_bounds__(kXieThreads)
xie_general_kernel(const float* __restrict__ tgt, int n_t,
                   const float* __restrict__ src, int n_s, float C,
                   float* __restrict__ out) {
  __shared__ float4 ra[kXieTile];
  __shared__ float2 rb[kXieTile];
  const float* rows = kTransposed ? src : tgt;
  const float* cols = kTransposed ? tgt : src;
  const int n_rows = kTransposed ? n_s : n_t;
  const int n_cols = kTransposed ? n_t : n_s;
  const int col_tiles = (n_cols + kXieTile - 1) / kXieTile;
  const long long n_pairs =
      (long long)((n_rows + kXieTile - 1) / kXieTile) * col_tiles;
  const int col = threadIdx.x % kXieTile;
  const int r0 = threadIdx.x / kXieTile * kXieRows;
  for (long long p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int i0 = (int)(p / col_tiles) * kXieTile;
    const int c = (int)(p % col_tiles) * kXieTile + col;
    __syncthreads();
    stage_rows(rows, n_rows, i0, ra, rb);
    float q[6];
    load_point(cols, n_cols, c, q);
    __syncthreads();
    const int r_end = c < n_cols ? min(r0 + kXieRows, n_rows - i0) : r0;
    float* dst = out + (size_t)(i0 + r0) * n_cols + c;
#pragma unroll 2
    for (int r = r0; r < r_end; ++r, dst += n_cols) {
      const float4 a = ra[r];
      const float2 b = rb[r];
      __stcs(dst, kTransposed
                      ? xie_pair(a.x, a.y, a.z, a.w, b.x, b.y, q[0], q[1],
                                 q[2], q[3], q[4], q[5], C)
                      : xie_pair(q[0], q[1], q[2], q[3], q[4], q[5], a.x,
                                 a.y, a.z, a.w, b.x, b.y, C));
    }
  }
}

// Launches kernel(args...) on a persistent grid for `work` tiles: as many
// blocks as the SMs hold at once, at most one a tile.
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), long long work,
                 cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kXieThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(int)(work < most ? work : most), kXieThreads, 0, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tgt (n_t, 6) and src (n_s, 6) row-major float32 on the device; out
// (n_t, n_s). Returns cudaGetLastError().
int dipole_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                   float eps, float* out, cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  const int col_blocks = (n_s + kCols - 1) / kCols;
  const int row_blocks = min((n_t + kRows - 1) / kRows, 65535);
  imatrix_kernel<<<dim3(col_blocks, row_blocks), kCols, 0, stream>>>(
      tgt, n_t, src, n_s, eps, out);
  return static_cast<int>(cudaGetLastError());
}

// The xie matrix of tgt (n_t, 6) and src (n_s, 6): out is I (n_t, n_s)
// when transposed == 0, I^T (n_s, n_t) otherwise. symmetric != 0 says that
// tgt holds the same points as src (n_t == n_s): each pair's terms then
// serve both I[i, j] and I[j, i]. Returns cudaGetLastError().
int xie_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                float C, int transposed, int symmetric, float* out,
                cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  const long long t_tiles = (n_t + kXieTile - 1) / kXieTile;
  const long long s_tiles = (n_s + kXieTile - 1) / kXieTile;
  if (symmetric) {
    if (n_t != n_s) return static_cast<int>(cudaErrorInvalidValue);
    const long long work = s_tiles * (s_tiles + 1) / 2;
    return transposed
               ? launch_tiles(xie_symmetric_kernel<true>, work, stream, src,
                              n_s, C, out)
               : launch_tiles(xie_symmetric_kernel<false>, work, stream, src,
                              n_s, C, out);
  }
  return transposed ? launch_tiles(xie_general_kernel<true>, t_tiles * s_tiles,
                                   stream, tgt, n_t, src, n_s, C, out)
                    : launch_tiles(xie_general_kernel<false>,
                                   t_tiles * s_tiles, stream, tgt, n_t, src,
                                   n_s, C, out);
}

}  // extern "C"
