// Dense dipole interaction matrix I[i, j] = E_j(x_i) . n_i, (N_t, N_s)
// row-major float32, eps 1e-6 by default (the greedy passes its own).
// Coincident pairs and non-finite entries are 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_dipole_imatrix_kernel (via
// dipole_interaction_matrix_pallas). The TPU build itself computes this
// matrix with the XLA fields.dipole_interaction_matrix; the port's greedy
// matrix tier (N <= MATRIX_LIMIT, ops/propagate.py:135), the dipole replay
// (:512) and each graph_dipole patch read rows of this kernel's output. It
// must stay bit-equal to the plain torch version (the row greedy and the
// replay decide on these bits): common.cuh's dipole_terms/dipole_value,
// -fmad=false, IEEE sqrtf and divides.
//
// The mirror-field ("xie") matrix, xie_imatrix below, replaces
// dipole_tpu/ops/fields_pallas.py:_xie_imatrix_kernel (:234-254, via
// xie_interaction_matrix_pallas :298): I (N_t, N_s) or, for the sequential
// xie loop, which reads columns, I^T (N_s, N_t) with the same bits entry for
// entry, bit-equal to the plain torch version too (common.cuh's
// xie_terms/xie_value).
//
// What bounds them on an H100: bytes written, N^2 x 4 B (400 MB at 10k:
// 0.12 ms at 3.35 TB/s; 3.6 GB at 30k: 1.075 ms). But an entry computed on
// its own costs ~69 issued instructions (one IEEE root and two or three
// IEEE divides, each with its check for the slow path): the kernels are
// held by instruction issue, and the design cuts instructions.
//
// Design: on the main paths the targets are the sources (symmetric mode,
// asked for by the caller, not inferred). There a block owns a tile pair
// (I_b, J_b) of kTile x kTile entries with J_b >= I_b, walking the upper
// triangle of tile pairs as a persistent grid (as many blocks as the SMs
// hold at once). For each pair (i in I_b, j in J_b) it computes the shared
// terms once and from them both I[i, j] and the mirror I[j, i] by an
// identity exact in float32 (common.cuh): I is not symmetric (the xie
// matrix differs from its transpose in 25% of the entries at 1500 points),
// but the mirror of the dipole entry -((3 c) Rn / D - pd) is -((3 Rn) c /
// D - pd), and of the xie entry (nn - (C nsR) ntR) / r3 it is (nn - (C
// ntR) nsR) / r3. A dipole pair costs one root and three divides for its
// two entries (pd is shared), a xie pair one root and four. The walk is
// one template (symmetric_tiles) over the pair type (DipolePair, XiePair).
// On an H100 (PERF.md) the dipole loop is ~105 SASS instructions a pair,
// ~52 an entry: 0.218 ms at 10k (0.326 for the one-entry-a-thread kernel
// before it, 55% of the bound); the xie loop ~93 a pair: 1.95 ms at 30k
// and 0.238 at 10k, I^T. A diagonal tile stores only its direct values.
// A thread owns one column j of the tile and kTile^2 / 256 rows (staged in
// shared memory, read by broadcast) and steps a pointer from row to row,
// so each warp store of the direct tile is 128 contiguous bytes; the
// mirror tile goes through shared memory, transposed, and is stored the
// same way. Every store carries the evict-first hint (st.global.cs): the
// matrix never fits the 50 MB L2. Bulk copies of both tiles from shared
// memory (cp.async.bulk) tied at 30k and lost 5% at 10k (PERF.md). Tiles
// are 64 x 64, or 32 x 32 where the tile pairs of 64 would not fill the
// blocks the card holds at once: at a graph_dipole patch of 458 points
// (36 pairs of 64, 120 of 32) the kernel takes 0.0033 ms with tiles of 32
// and 0.0076 with tiles of 64 (the one-entry kernel: 0.0040); from 2000
// points on, tiles of 64 are faster (10000: 0.218 against 0.261 ms). In
// general mode (targets other than the sources) a block owns one output
// tile (general_tiles) and computes each entry on its own: the same tiling
// and stores, no mirror (0.287 ms at 10k; 0.326 before). Either layout of
// the xie matrix is the same kernel with the values swapped; the dipole
// matrix is written as I only.
#include "common.cuh"

namespace {

constexpr int kTileThreads = 256;                  // a block

// The pair types of the tile kernels. entry(s, t): the entry of source s
// at target t (6 floats each: position, then moment or normal). both(s, a,
// b, direct, mirror): from the terms of source s (in registers) at target
// (a, b) (staged), that entry I[t, s] and the mirror entry I[s, t].
struct DipolePair {
  float eps;
  __device__ __forceinline__ float entry(const float* s, const float* t) const {
    return dipole_pair(s[0], s[1], s[2], s[3], s[4], s[5], t[0], t[1], t[2],
                       t[3], t[4], t[5], eps);
  }
  __device__ __forceinline__ void both(const float* s, float4 a, float2 b,
                                       float& direct, float& mirror) const {
    const DipoleTerms m = dipole_terms(s[0], s[1], s[2], s[3], s[4], s[5], a.x,
                                       a.y, a.z, a.w, b.x, b.y, eps);
    direct = dipole_value(m, m.c, m.Rn);
    mirror = dipole_value(m, m.Rn, m.c);
  }
};

struct XiePair {
  float C;
  __device__ __forceinline__ float entry(const float* s, const float* t) const {
    return xie_pair(s[0], s[1], s[2], s[3], s[4], s[5], t[0], t[1], t[2],
                    t[3], t[4], t[5], C);
  }
  __device__ __forceinline__ void both(const float* s, float4 a, float2 b,
                                       float& direct, float& mirror) const {
    const XieTerms m = xie_terms(s[0], s[1], s[2], s[3], s[4], s[5], a.x, a.y,
                                 a.z, a.w, b.x, b.y);
    direct = xie_value(m, m.nsR, m.ntR, C);
    mirror = xie_value(m, m.ntR, m.nsR, C);
  }
};

// Rows [r0, r0 + kTile) of pts (n, 6) into shared memory, zeros past n.
template <int kTile>
__device__ __forceinline__ void stage_rows(const float* __restrict__ pts,
                                           int n, int r0, float4* ra,
                                           float2* rb) {
  if (threadIdx.x < kTile) {
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
// registers, i = I0 + r for its kRows rows r from r0 the targets staged
// in shared memory; the direct value goes to out[i, j], the mirror value to
// out[j, i] through the transposed tile in shared memory (I^T: the other
// way round). A diagonal tile stores only the direct values.
template <typename Pair, bool kTransposed, int kTile>
__global__ void __launch_bounds__(kTileThreads)
symmetric_tiles(const float* __restrict__ pts, int n, Pair pair,
                float* __restrict__ out) {
  constexpr int kRows = kTile * kTile / kTileThreads;   // rows a thread
  __shared__ float4 ra[kTile];                 // x, y, z, nx
  __shared__ float2 rb[kTile];                 // ny, nz
  __shared__ float mirror[kTile][kTile + 1];   // [j - J0][i - I0]
  const int n_tiles = (n + kTile - 1) / kTile;
  const int col = threadIdx.x % kTile;
  const int r0 = threadIdx.x / kTile * kRows;
  int bi = 0, bj = 0;
  advance(bi, bj, blockIdx.x, n_tiles);
  for (; bi < n_tiles; advance(bi, bj, gridDim.x, n_tiles)) {
    const int i0 = bi * kTile, j0 = bj * kTile;
    __syncthreads();                           // the last pair is spent
    stage_rows<kTile>(pts, n, i0, ra, rb);
    float q[6];
    load_point(pts, n, j0 + col, q);
    __syncthreads();
    const int r_end = j0 + col < n ? min(r0 + kRows, n - i0) : r0;
    float* dst = out + (size_t)(i0 + r0) * n + j0 + col;
#pragma unroll 2
    for (int r = r0; r < r_end; ++r, dst += n) {
      float direct, mirrored;                  // I[i, j], I[j, i]
      pair.both(q, ra[r], rb[r], direct, mirrored);
      __stcs(dst, kTransposed ? mirrored : direct);
      mirror[col][r] = kTransposed ? direct : mirrored;
    }
    if (bi != bj) {
      __syncthreads();
      const int m_end = i0 + col < n ? min(r0 + kRows, n - j0) : r0;
      float* mdst = out + (size_t)(j0 + r0) * n + i0 + col;
#pragma unroll 4
      for (int r = r0; r < m_end; ++r, mdst += n) __stcs(mdst, mirror[r][col]);
    }
  }
}

// General mode: out (n_t, n_s) is I of src at tgt, or (kTransposed) I^T
// (n_s, n_t). A block owns output tiles of kTile x kTile, a thread
// one column (its point in registers) and kRows rows (staged). Six blocks
// an SM (at most 40 registers): the xie entry took 43 without the bound,
// five blocks an SM, 2-3% more time (PERF.md).
template <typename Pair, bool kTransposed, int kTile>
__global__ void __launch_bounds__(kTileThreads, 6)
general_tiles(const float* __restrict__ tgt, int n_t,
              const float* __restrict__ src, int n_s, Pair pair,
              float* __restrict__ out) {
  constexpr int kRows = kTile * kTile / kTileThreads;
  __shared__ float4 ra[kTile];
  __shared__ float2 rb[kTile];
  const float* rows = kTransposed ? src : tgt;
  const float* cols = kTransposed ? tgt : src;
  const int n_rows = kTransposed ? n_s : n_t;
  const int n_cols = kTransposed ? n_t : n_s;
  const int col_tiles = (n_cols + kTile - 1) / kTile;
  const long long n_pairs =
      (long long)((n_rows + kTile - 1) / kTile) * col_tiles;
  const int col = threadIdx.x % kTile;
  const int r0 = threadIdx.x / kTile * kRows;
  for (long long p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int i0 = (int)(p / col_tiles) * kTile;
    const int c = (int)(p % col_tiles) * kTile + col;
    __syncthreads();
    stage_rows<kTile>(rows, n_rows, i0, ra, rb);
    float q[6];
    load_point(cols, n_cols, c, q);
    __syncthreads();
    const int r_end = c < n_cols ? min(r0 + kRows, n_rows - i0) : r0;
    float* dst = out + (size_t)(i0 + r0) * n_cols + c;
#pragma unroll 2
    for (int r = r0; r < r_end; ++r, dst += n_cols) {
      const float4 a = ra[r];
      const float2 b = rb[r];
      const float row[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
      __stcs(dst, kTransposed ? pair.entry(row, q) : pair.entry(q, row));
    }
  }
}

// The blocks of kernel the card holds at once: its SMs x the blocks an SM
// holds.
template <typename... Params>
int resident_blocks(void (*kernel)(Params...), long long* most) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTileThreads, 0);
  *most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(e);
}

// Launches kernel(args...) on a persistent grid for `work` tiles: as many
// blocks as the card holds at once, at most one a tile.
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), long long work,
                 cudaStream_t stream, Args... args) {
  long long most = 0;
  const int e = resident_blocks(kernel, &most);
  if (e != 0) return e;
  kernel<<<(int)(work < most ? work : most), kTileThreads, 0, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The matrix of pair type Pair for tgt (n_t, 6) and src (n_s, 6): I
// (n_t, n_s), or I^T (n_s, n_t) in kTransposed; symmetric: tgt holds the
// same points as src (n_t == n_s). Tiles of 64 x 64 entries, or of 32 x 32
// where the tiles of 64 would not fill the blocks the card holds at once.
template <typename Pair, bool kTransposed>
int launch_matrix(Pair pair, const float* tgt, int n_t, const float* src,
                  int n_s, bool symmetric, float* out, cudaStream_t stream) {
  long long most = 0;
  if (symmetric) {
    const long long w64 = (n_s + 63) / 64 * ((n_s + 63) / 64 + 1LL) / 2;
    const long long w32 = (n_s + 31) / 32 * ((n_s + 31) / 32 + 1LL) / 2;
    const int e = resident_blocks(symmetric_tiles<Pair, kTransposed, 64>, &most);
    if (e != 0) return e;
    if (w64 < most)
      return launch_tiles(symmetric_tiles<Pair, kTransposed, 32>, w32, stream,
                          src, n_s, pair, out);
    return launch_tiles(symmetric_tiles<Pair, kTransposed, 64>, w64, stream,
                        src, n_s, pair, out);
  }
  const long long w64 = (n_t + 63) / 64 * (long long)((n_s + 63) / 64);
  const long long w32 = (n_t + 31) / 32 * (long long)((n_s + 31) / 32);
  const int e = resident_blocks(general_tiles<Pair, kTransposed, 64>, &most);
  if (e != 0) return e;
  if (w64 < most)
    return launch_tiles(general_tiles<Pair, kTransposed, 32>, w32, stream, tgt,
                        n_t, src, n_s, pair, out);
  return launch_tiles(general_tiles<Pair, kTransposed, 64>, w64, stream, tgt,
                      n_t, src, n_s, pair, out);
}

}  // namespace

extern "C" {

// The dipole matrix of tgt (n_t, 6) and src (n_s, 6), row-major float32 on
// the device: out (n_t, n_s). symmetric != 0 says that tgt holds the same
// points as src (n_t == n_s): each pair's terms then serve both I[i, j]
// and I[j, i]. Returns cudaGetLastError().
int dipole_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                   float eps, int symmetric, float* out, cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  if (symmetric && n_t != n_s) return static_cast<int>(cudaErrorInvalidValue);
  return launch_matrix<DipolePair, false>(DipolePair{eps}, tgt, n_t, src, n_s,
                                          symmetric != 0, out, stream);
}

// The xie matrix of tgt (n_t, 6) and src (n_s, 6): out is I (n_t, n_s)
// when transposed == 0, I^T (n_s, n_t) otherwise; symmetric as above.
// Returns cudaGetLastError().
int xie_imatrix(const float* tgt, int n_t, const float* src, int n_s,
                float C, int transposed, int symmetric, float* out,
                cudaStream_t stream) {
  if (n_t <= 0 || n_s <= 0) return 0;
  if (symmetric && n_t != n_s) return static_cast<int>(cudaErrorInvalidValue);
  return transposed ? launch_matrix<XiePair, true>(XiePair{C}, tgt, n_t, src,
                                                   n_s, symmetric != 0, out,
                                                   stream)
                    : launch_matrix<XiePair, false>(XiePair{C}, tgt, n_t, src,
                                                    n_s, symmetric != 0, out,
                                                    stream);
}

}  // extern "C"
