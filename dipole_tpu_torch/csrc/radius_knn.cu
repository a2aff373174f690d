// Radius-bounded k nearest neighbours of a whole cloud among its own points:
// for every point q of pos (N, 3), the up to k <= 64 points of pos nearest to
// q with d2 <= r2, q itself included, ordered by (d2, index) ascending, so
// that ties go to the lower index. d2 = dx*dx + dy*dy + dz*dz with dx =
// q - point, each product and sum rounded apart (-fmad=false), in the order
// of the plain version (ops/neighbors_cuda.radius_knn_plain: the dense scan
// of ops/neighbors.knn, then the radius mask), to which idx and d2 are
// bit-equal. Slots past the last neighbour inside the radius read index 0
// and d2 = +inf. Outputs idx (int32) and d2 (float32), (N, k), in the
// cloud's order. Positions are finite.
//
// Replaces no kernel of the JAX package: dipole_tpu/ops/estimate.py searches
// on the host KD-tree (native/dipole_native.cpp's dn_knn), which the port
// keeps for a CPU device. It is normal estimation's search on the card
// (ops/estimate.py, Open3D's hybrid criterion: up to k nearest, then the
// radius), whose answers the card's PCA gathers where they lie.
// csrc/knn.cu cannot serve: it stages a batch row's sources (at most 8192)
// in shared memory.
//
// What bounds it on an H100: bytes, from the shapes. The least work is the
// input read once (12 N bytes) and the outputs written once (8 N k bytes):
// 45.4 MB at N = 180000, k = 30, 13.6 us at 3.35 TB/s; the distances an
// exact search must take, at least N k, are 49 M operations (0.7 us). What
// the card spends beyond that is the candidates scanned and the inserts:
// 1.2 ms at N = 180000, k = 30 on an H100 (PERF.md).
//
// Design: bucket the points into a uniform grid of cubic cells, then search
// each query's cells ring by ring, nearest ring first.
//  - plan (one block): the bounding box, and the smallest cell edge h (grown
//    by 1/16 from the lower bound that the box's volume, area and length
//    give) for which the grid has at most cells_max <= N cells, so a far
//    outlier makes the cells large, never the grid huge. Keys: the cell of
//    each point, (cx gy + cy) gz + cz, from floor((p - lo) / h).
//  - The keys are sorted by the caller (torch.sort); stage: the points in
//    key order as float4 (x, y, z, index bits), and each cell's first sorted
//    position by binary search, so a run of cells along z is one span.
//  - search: a thread a query, the queries in key order, so a warp's
//    queries share cells. Ring m holds the cells at Chebyshev distance m
//    from the query's cell. Each thread keeps its k best (d2, index) pairs
//    in a list sorted by (d2, index), the kernel templated on the list's
//    size K = 8, 16, 32 or 64 and its loops fully unrolled (ptxas keeps the
//    lists of 32 and 64 in registers and those of 8 and 16 in local
//    memory, which still beat the list of 32 at k <= 16 by 13-35% at
//    N = 180000), and inserts a point only if d2 <= r2 and (d2, index) comes
//    before the list's k-th pair. The scan order does not matter: any order
//    of the points leaves the same k smallest pairs. After ring m the
//    thread stops when min(k-th d2, r2) is below the squared distance from
//    the query to the nearest face of the scanned block, shrunk by a slack
//    that covers the rounding of the cell assignment and of d2: no point
//    left can then enter the list.
//
// Lanes of a warp insert when they find a pair, not together as knn.cu's
// lanes do: a query here scans its own cells and stops on its own, and the
// neighbours of a query come mostly from its first two rings.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kPlanThreads = 1024;
constexpr int kThreads = 128;
constexpr float kShrink = 0.999999f;   // the stop test's d2 rounding margin

// The grid, written by radius_knn_plan and read by the others.
struct Grid {
  float lo[3];
  float h, inv_h, slack;
  int g[3];
};

__device__ __forceinline__ int cell_of(float p, float lo, float inv_h, int g) {
  const int c = static_cast<int>(floorf((p - lo) * inv_h));
  return min(max(c, 0), g - 1);
}

__device__ __forceinline__ int key_of(const Grid& G, float x, float y, float z) {
  const int cx = cell_of(x, G.lo[0], G.inv_h, G.g[0]);
  const int cy = cell_of(y, G.lo[1], G.inv_h, G.g[1]);
  const int cz = cell_of(z, G.lo[2], G.inv_h, G.g[2]);
  return (cx * G.g[1] + cy) * G.g[2] + cz;
}

// (d, j) comes before (v, i) in (d2, index) order.
__device__ __forceinline__ bool before(float d, int j, float v, int i) {
  return d < v || (d == v && j < i);
}

// The grid's dims at edge h, as the keys compute them (the largest key of
// an axis is that of its box maximum); false when more than cells_max.
__device__ bool grid_dims(const float* lo, const float* hi, double h,
                          long long cells_max, Grid& G) {
  const float hf = static_cast<float>(h);
  const float inv = 1.f / hf;
  long long prod = 1;
  for (int a = 0; a < 3; ++a) {
    const float t = floorf((hi[a] - lo[a]) * inv);
    if (!(t < 1073741824.f)) return false;
    G.g[a] = static_cast<int>(t) + 1;
    prod *= G.g[a];
    if (prod > cells_max) return false;
  }
  G.h = hf;
  G.inv_h = inv;
  return true;
}

__global__ void __launch_bounds__(kPlanThreads)
radius_knn_plan(const float* __restrict__ pos, int n, int cells_max, Grid* grid,
            int* __restrict__ keys) {
  __shared__ float s_lo[3][kPlanThreads / 32], s_hi[3][kPlanThreads / 32];
  __shared__ Grid s_grid;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], pos[3 * (size_t)i + a]);
      hi[a] = fmaxf(hi[a], pos[3 * (size_t)i + a]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
    if (lane == 0) {
      s_lo[a][warp] = lo[a];
      s_hi[a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = blockDim.x >> 5;
    for (int a = 0; a < 3; ++a) {
      for (int w = 1; w < warps; ++w) {
        s_lo[a][0] = fminf(s_lo[a][0], s_lo[a][w]);
        s_hi[a][0] = fmaxf(s_hi[a][0], s_hi[a][w]);
      }
      lo[a] = s_lo[a][0];
      hi[a] = s_hi[a][0];
    }
    Grid G;
    double e[3], emax = 0.0, amax = 0.0;
    for (int a = 0; a < 3; ++a) {
      G.lo[a] = lo[a];
      e[a] = static_cast<double>(hi[a]) - static_cast<double>(lo[a]);
      emax = fmax(emax, e[a]);
      amax = fmax(amax, fmax(fabs((double)lo[a]), fabs((double)hi[a])));
    }
    bool planned = false;
    if (emax > 0.0 && isfinite(emax) && cells_max > 1) {
      // extents in descending order: the grid needs h above each of the
      // length, area and volume bounds before it can hold cells_max cells
      double s0 = e[0], s1 = e[1], s2 = e[2], t;
      if (s0 < s1) { t = s0; s0 = s1; s1 = t; }
      if (s1 < s2) { t = s1; s1 = s2; s2 = t; }
      if (s0 < s1) { t = s0; s0 = s1; s1 = t; }
      const double c = static_cast<double>(cells_max);
      double h = fmax(s0 / c, fmax(sqrt(s0 * s1 / c), cbrt(s0 * s1 * s2 / c)));
      for (int it = 0; it < 1024 && !planned; ++it, h *= 1.0625)
        planned = grid_dims(lo, hi, h, cells_max, G);
    }
    if (!planned) {   // one cell: every point, every query
      G.h = 1.f;
      G.inv_h = 0.f;
      G.g[0] = G.g[1] = G.g[2] = 1;
    }
    // covers the rounding of a point's cell against the faces of a block:
    // a few ulps of the coordinates' magnitude
    G.slack = static_cast<float>(2e-6 * (emax + amax));
    s_grid = G;
    *grid = G;
  }
  __syncthreads();
  const Grid G = s_grid;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    keys[i] = key_of(G, pos[3 * (size_t)i], pos[3 * (size_t)i + 1],
                     pos[3 * (size_t)i + 2]);
}

// Points in key order as (x, y, z, index bits); starts[c] = the first sorted
// position of cell c (a binary search), n past the last cell.
__global__ void __launch_bounds__(kThreads)
radius_knn_stage(const float* __restrict__ pos, const int* __restrict__ sorted_keys,
             const int64_t* __restrict__ order, int n, int cells_max,
             const Grid* __restrict__ grid, float4* __restrict__ spos,
             int* __restrict__ starts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const int o = static_cast<int>(order[t]);
    spos[t] = make_float4(pos[3 * (size_t)o], pos[3 * (size_t)o + 1],
                          pos[3 * (size_t)o + 2], __int_as_float(o));
  }
  if (t <= cells_max) {
    const int cells = grid->g[0] * grid->g[1] * grid->g[2];
    int a = t <= cells ? 0 : n, b = n;   // past the grid's cells: n
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (sorted_keys[mid] < t) a = mid + 1; else b = mid;
    }
    starts[t] = a;
  }
}

template <int K>
__device__ __forceinline__ void insert(float (&v)[K], int (&ix)[K], int k, float d,
                                       int j) {
  // (d, j) comes before the k-th pair: the pairs after its place move down
  // one slot, the k-th drops out; slots past k stay as they are
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (s < k && before(d, j, v[s], ix[s])) {
      const bool up = before(d, j, v[s - 1], ix[s - 1]);
      v[s] = up ? v[s - 1] : d;
      ix[s] = up ? ix[s - 1] : j;
    }
  }
  if (before(d, j, v[0], ix[0])) {
    v[0] = d;
    ix[0] = j;
  }
}

// The points of sorted positions [a, b) against query q: each that passes
// the radius and comes before the k-th pair goes into the list.
template <int K>
__device__ __forceinline__ void scan_span(const float4* __restrict__ spos, int a,
                                          int b, float4 q, int k, float r2,
                                          float (&v)[K], int (&ix)[K], float& tv,
                                          int& ti) {
  for (int j = a; j < b; ++j) {
    const float4 c = spos[j];
    const float dx = q.x - c.x;
    const float dy = q.y - c.y;
    const float dz = q.z - c.z;
    const float d = dx * dx + dy * dy + dz * dz;
    const int id = __float_as_int(c.w);
    if (d <= r2 && before(d, id, tv, ti)) {
      insert(v, ix, k, d, id);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s == k - 1) {
          tv = v[s];
          ti = ix[s];
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
radius_knn_search(const float4* __restrict__ spos, const int* __restrict__ starts,
              const Grid* __restrict__ grid, int n, int k, float r2,
              int* __restrict__ out_idx, float* __restrict__ out_d2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const Grid G = *grid;
  const float4 q = spos[t];
  const int cx = cell_of(q.x, G.lo[0], G.inv_h, G.g[0]);
  const int cy = cell_of(q.y, G.lo[1], G.inv_h, G.g[1]);
  const int cz = cell_of(q.z, G.lo[2], G.inv_h, G.g[2]);
  float v[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    v[r] = INFINITY;
    ix[r] = INT_MAX;
  }
  float tv = INFINITY;   // the k-th pair
  int ti = INT_MAX;

  const int rings = max(G.g[0], max(G.g[1], G.g[2]));
  for (int m = 0; m < rings; ++m) {
    const int x0 = max(cx - m, 0), x1 = min(cx + m, G.g[0] - 1);
    const int y0 = max(cy - m, 0), y1 = min(cy + m, G.g[1] - 1);
    const int z0 = max(cz - m, 0), z1 = min(cz + m, G.g[2] - 1);
    for (int x = x0; x <= x1; ++x) {
      const bool xface = x == cx - m || x == cx + m;
      for (int y = y0; y <= y1; ++y) {
        const int row = (x * G.g[1] + y) * G.g[2];
        // the whole z run on a face of the block, else its two ends
        int a0 = 0, b0 = 0, a1 = 0, b1 = 0;
        if (xface || y == cy - m || y == cy + m) {
          a0 = starts[row + z0];
          b0 = starts[row + z1 + 1];
        } else {
          if (cz - m >= 0) {
            a0 = starts[row + cz - m];
            b0 = starts[row + cz - m + 1];
          }
          if (cz + m < G.g[2]) {
            a1 = starts[row + cz + m];
            b1 = starts[row + cz + m + 1];
          }
        }
#pragma unroll 1
        for (int part = 0; part < 2; ++part)
          scan_span<K>(spos, part ? a1 : a0, part ? b1 : b0, q, k, r2, v, ix, tv, ti);
      }
    }
    // the distance to the nearest face of the scanned block that has cells
    // beyond it
    float bd = INFINITY;
    if (cx - m > 0) bd = fminf(bd, q.x - (G.lo[0] + (float)(cx - m) * G.h));
    if (cx + m + 1 < G.g[0]) bd = fminf(bd, G.lo[0] + (float)(cx + m + 1) * G.h - q.x);
    if (cy - m > 0) bd = fminf(bd, q.y - (G.lo[1] + (float)(cy - m) * G.h));
    if (cy + m + 1 < G.g[1]) bd = fminf(bd, G.lo[1] + (float)(cy + m + 1) * G.h - q.y);
    if (cz - m > 0) bd = fminf(bd, q.z - (G.lo[2] + (float)(cz - m) * G.h));
    if (cz + m + 1 < G.g[2]) bd = fminf(bd, G.lo[2] + (float)(cz + m + 1) * G.h - q.z);
    if (bd == INFINITY) break;                       // every cell scanned
    bd -= G.slack;
    if (bd > 0.f && fminf(tv, r2) < bd * bd * kShrink) break;
  }

  const int self = __float_as_int(q.w);
  int* oi = out_idx + (size_t)self * k;
  float* od = out_d2 + (size_t)self * k;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r < k) {
      oi[r] = ix[r] == INT_MAX ? 0 : ix[r];
      od[r] = v[r];
    }
  }
}

}  // namespace

extern "C" {

int dipole_radius_knn_max_k() { return kMaxK; }

// pos (n, 3) float32 on the device; grid: 64 bytes of scratch; keys (n)
// int32. Writes the grid of at most cells_max cells (1 <= cells_max) and
// each point's key. Returns cudaGetLastError().
int dipole_radius_knn_bucket(const float* pos, int n, int cells_max, void* grid,
                             int* keys, cudaStream_t stream) {
  if (n <= 0 || cells_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  radius_knn_plan<<<1, kPlanThreads, 0, stream>>>(pos, n, cells_max,
                                              static_cast<Grid*>(grid), keys);
  return static_cast<int>(cudaGetLastError());
}

// pos, grid as above; sorted_keys (n) int32 and order (n) int64 from a
// stable sort of the keys; spos (n, 4) float32 and starts (cells_max + 1)
// int32 scratch; out_idx (n, k) int32 and out_d2 (n, k) float32. 0 < k <= 64.
// Returns cudaGetLastError().
int dipole_radius_knn_search(const float* pos, const int* sorted_keys,
                             const int64_t* order, int n, int cells_max,
                             const void* grid, int k, float r2, void* spos,
                             int* starts, int* out_idx, float* out_d2,
                             cudaStream_t stream) {
  if (n <= 0 || cells_max <= 0 || k <= 0 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid* g = static_cast<const Grid*>(grid);
  float4* sp = static_cast<float4*>(spos);
  const int staged = n > cells_max ? n : cells_max + 1;
  radius_knn_stage<<<(staged + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pos, sorted_keys, order, n, cells_max, g, sp, starts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 blocks((n + kThreads - 1) / kThreads);
  if (k <= 8)
    radius_knn_search<8><<<blocks, kThreads, 0, stream>>>(sp, starts, g, n, k, r2, out_idx, out_d2);
  else if (k <= 16)
    radius_knn_search<16><<<blocks, kThreads, 0, stream>>>(sp, starts, g, n, k, r2, out_idx, out_d2);
  else if (k <= 32)
    radius_knn_search<32><<<blocks, kThreads, 0, stream>>>(sp, starts, g, n, k, r2, out_idx, out_d2);
  else
    radius_knn_search<64><<<blocks, kThreads, 0, stream>>>(sp, starts, g, n, k, r2, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
