// The strongest-field greedy ordering, the whole loop in one cooperative
// kernel.
//
// Replaces: dipole_tpu/ops/propagate_pallas.py:_greedy_kernel (VMEM-resident,
// N <= 131072), _greedy_streamed_kernel (HBM-streamed, N <= 1M) and
// _greedy_xl_kernel (state in HBM too, N <= 2^24) with one design over the
// whole range up to 2^24 points; and, in row mode, the XLA scan
// dipole_tpu/ops/propagate.py:_greedy_scan_matrix of the matrix tier.
//
// The loop: acc starts as the start point's vector and the start point is
// visited at +1. Then for N-1 steps: pick the unvisited point with the
// largest |acc| (ties to the lowest index), set its sign to -1 if its
// acc < 0 else +1, and add sign x its vector to acc. Exactly N-1 steps run:
// the JAX package's bucket padding, dead steps and launch segments were TPU
// artefacts. Two update modes share the loop:
//   row mode    reads row c of the precomputed matrix I (the matrix tier,
//               propagate.py:82-106: I[c] stands in for the column by
//               symmetry, as in the JAX scan);
//   column mode computes column c on the fly from the cloud, the formula of
//               propagate.py:_dipole_column (109-124).
// A third loop, the xie mode (xie_greedy_kernel below), runs the mirror-field
// propagation over rows of the transposed xie matrix on the same grid.
//
// What bounds it on an H100: latency. The N - 1 picks depend on each other:
// step k + 1's column is that of step k's winner, a global argmax over all of
// acc. So a step costs at least one exchange between the SMs through L2, and
// at N = 180k that exchange, not the step's N interaction terms (~37 flops
// each, 1.36 points a thread on 132 x 1024 threads), sets the time. The
// operations bound of PERF.md ignores that chain. chip_smoke.py separates
// the two costs: on a fixed grid it fits the time a step against the points
// a thread (the intercept: the exchange and the block's reductions; the
// slope: the sweep), and at a fixed size it times a step against the grid's
// block count.
//
// Design (greedy_owner_kernel): a cooperative launch, one block per SM at
// most, so that every block is resident and a block may spin on another's
// flag. Thread t owns points t, t + G T, t + 2 G T, ... for the whole run
// (G blocks of T threads), and the state stays with its owner:
//   - acc of its points in registers, visited and sign as bits of two
//     registers (kPer points a thread, a power of two up to 8 with T = 1024
//     threads a block); in column mode the points' six coordinates in
//     shared memory (24 kPer T bytes);
//     acc and sign are written to global memory once, at the end. Up to
//     kPointsPerSM points a block (1.08M on 132 SMs) fit; above that, or
//     above a lower cap that only tests pass, the kPer = 0 instance keeps
//     acc and sign in global memory, so the whole range up to 2^24 stays.
//   - a candidate is one 64-bit key whose unsigned order is the greedy's:
//     the bits of |acc| (a non-negative float orders as its bits), then
//     2^24 - index (ties to the lowest index; so n <= 2^24), then the sign
//     of acc. Warps reduce keys with two __reduce_max_sync, not chains of
//     shuffles of (|acc|, index, acc). The key with the step's tag in six
//     free bits is what a block publishes: one 8-byte word, read whole
//     (single-copy atomic), so it needs no flag beside it and no fence (a
//     release flag beside a wider slot, polled with acquire loads, was
//     slower than grid.sync(); PERF.md). The column mode's coordinates
//     do not fit; the polling lanes fetch those of their own best
//     candidates from the cloud (L2-resident, 24 B a point) while the warp
//     reduces, so the winner's arrive with it. Row mode then reads the
//     winner's row of I, the one dependent load left, all of a thread's
//     entries at once.
//   - one exchange a step: lane 0 of warp 0 stores the block's word; warp 0
//     of every block loads all G words together (each lane its own blocks,
//     all loads in flight at once) until every tag shows the step, reduces
//     the keys and hands the winner to its block through shared memory;
//     one __syncthreads. The words are zeroed by the wrapper for every
//     launch.
// Why one exchange a step is enough: the words are double-buffered by step
// parity, and a block can overwrite step k's word only at step k + 2, after
// it has seen every block's word of step k + 1; a block stores that word
// only after its reads of step k's words have returned (it needs their
// values to get there), and a tag (step + 1 mod 64) never matches the word
// of step k - 2 left in the same place. So no word is overwritten before
// every block has read it, and none is read stale. Up to a few thousand
// points the grid is one block, which needs no exchange at all; one block
// computes 1-8 column entries a thread a step, so the column mode's
// threshold lies lower than the row mode's (chip_smoke.py times both sides
// of each). The block shape
// (1024 threads, against 256 and 512) was measured too (PERF.md).
//
// Arithmetic: compiled with -fmad=false; sqrtf and / are IEEE, and the
// column follows propagate.py:_dipole_column term for term in the plain
// torch version's order (two divides, not the Pallas kernels'
// single-reciprocal form of propagate_pallas.py:73-74). The acc update adds
// s x col with s = +-1, which is exact before the one rounding of the add.
// So the kernel and its plain version agree bit for bit in acc and sign.

#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;               // a block, every mode
constexpr int kOneBlockMaxN = 3 * kThreads;  // xie mode's one-block limit
constexpr int kMaxK = 256;  // kNN mask width of the xie mode
// the greedy's owner-state kernel
constexpr int kPointsPerSM = 8192;        // state held by one block
constexpr int kMaxPer = kPointsPerSM / kThreads;  // points a thread
// one block up to these many points (measured, PERF.md)
constexpr int kRowsOneBlockMaxN = 5120;
constexpr int kColumnsOneBlockMaxN = 4096;
constexpr int kMaxN = 1 << 24;            // the key's index field
constexpr int kPoll = 8;                  // words a lane polls: <= 256 blocks
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  float v;  // |acc| of an unvisited point
  int i;    // its index
  float a;  // its signed acc
};

__device__ __forceinline__ bool better(float v, int i, const Cand& b) {
  return v > b.v || (v == b.v && i < b.i);
}

__device__ __forceinline__ void warp_reduce(Cand& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, b.v, off);
    const int i = __shfl_down_sync(0xffffffffu, b.i, off);
    const float a = __shfl_down_sync(0xffffffffu, b.a, off);
    if (better(v, i, b)) b = Cand{v, i, a};
  }
}

// Block-wide (max, min-index) reduction; every thread gets the result.
__device__ Cand block_reduce(Cand b, Cand* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(b);
  if (lane == 0) sh[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < (int)(blockDim.x >> 5) ? sh[lane] : Cand{-INFINITY, INT_MAX, 0.f};
    warp_reduce(b);
    if (lane == 0) sh[32] = b;
  }
  __syncthreads();
  const Cand r = sh[32];
  __syncthreads();
  return r;
}

// I[i, c] = E_c(x_i) . n_i; p points at point i's x in a channel-major
// array [x, y, z, nx, ny, nz] whose planes lie `plane` floats apart.
__device__ __forceinline__ float column_entry(const float* __restrict__ p,
                                              size_t plane, float sx,
                                              float sy, float sz, float spx,
                                              float spy, float spz, float eps) {
  const float x = p[0], y = p[plane], z = p[2 * plane];
  const float nx = p[3 * plane], ny = p[4 * plane], nz = p[5 * plane];
  const float Rx = sx - x;
  const float Ry = sy - y;
  const float Rz = sz - z;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float r = sqrtf(r2);
  const float denom = r * r2 + eps;
  const float cdot = Rx * spx + Ry * spy + Rz * spz;
  const float Rn = Rx * nx + Ry * ny + Rz * nz;
  const float pn = nx * spx + ny * spy + nz * spz;
  const float safe_r2 = zero ? 1.f : r2;
  const float col = -(3.f * cdot * Rn / (safe_r2 * denom) - pn / denom);
  return (zero || !isfinite(col)) ? 0.f : col;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A candidate as one 64-bit key whose unsigned order is the greedy's: the
// bits of |acc| (a non-negative float orders as its bits) high; low, 2^24 - i
// (the lower index the larger) above one bit for acc < 0. 0: no candidate.
// Bits 26-31 stay free for the exchange's step tag.
constexpr unsigned kTagShift = 26;
constexpr unsigned long long kTagMask = 0x3full << kTagShift;

__device__ __forceinline__ unsigned long long cand_key(float a, int i) {
  return ((unsigned long long)__float_as_uint(fabsf(a)) << 32) |
         ((unsigned)((1 << 24) - i) << 1) | (a < 0.f ? 1u : 0u);
}

__device__ __forceinline__ int key_index(unsigned long long k) {
  return (1 << 24) - (int)(((unsigned)k >> 1) & 0x1ffffffu);
}

// The largest key of the warp, in every lane: two hardware reductions.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// The greedy with the state kept by its owner (see the note at the top).
// kPer > 0: kPer points a thread, acc in registers, visited and sign as bits,
// coordinates (column mode) in shared memory; kPer == 0: acc and sign in
// global memory. Blocks of kThreads; slots: 2 x gridDim.x words, zero on
// entry.
template <bool kRows, int kPer>
__global__ void __launch_bounds__(kThreads, 1)
greedy_owner_kernel(const float* __restrict__ data, int n, int start, float eps,
                    float* __restrict__ acc_out, float* __restrict__ sign_out,
                    unsigned long long* __restrict__ slots) {
  extern __shared__ float sh_pts[];  // column mode, kPer > 0: 6 planes of kPer T
  __shared__ unsigned long long wsh[32];
  __shared__ unsigned long long win_key;
  __shared__ float win_p[6];
  constexpr int kSlots = kPer > 0 ? kPer : 1;
  constexpr int T = kThreads;
  const size_t nn = n;
  const int G = gridDim.x;
  const int stride = G * T;
  const int tid = blockIdx.x * T + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int P = kPer * T;
  float acc[kSlots];
  unsigned vis = 0u, neg = 0u;  // bit j: point j visited; its sign is -1
  if (!kRows && kPer > 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = tid + j * stride;
      const int l = j * T + threadIdx.x;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) sh_pts[ch * P + l] = i < n ? data[ch * nn + i] : 0.f;
    }
  }
  int c = start;
  float s = 1.f;
  float src[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!kRows) {
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) src[ch] = data[ch * nn + c];
  }
  for (int step = 0; step < n; ++step) {
    unsigned long long best = 0ull;
    if (kPer > 0) {
      // row mode: every entry of the row the thread needs, loaded at once
      // (one after the other, they cost a memory latency each)
      float row[kSlots];
      if (kRows) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int i = tid + j * stride;
          row[j] = i < n ? data[(size_t)c * nn + i] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = tid + j * stride;
        if (i < n) {
          const unsigned bit = 1u << j;
          const float col =
              kRows ? row[j]
                    : column_entry(sh_pts + j * T + threadIdx.x, P, src[0], src[1],
                                   src[2], src[3], src[4], src[5], eps);
          float a;
          if (step == 0) {
            a = col;
            if (i == start) vis |= bit;
          } else {
            a = acc[j] + s * col;
            if (i == c) {
              vis |= bit;
              if (s < 0.f) neg |= bit;
            }
          }
          acc[j] = a;
          if (!(vis & bit)) best = max(best, cand_key(a, i));
        }
      }
    } else {
      for (int i = tid; i < n; i += stride) {
        const float col = kRows ? data[(size_t)c * nn + i]
                                : column_entry(data + i, nn, src[0], src[1], src[2],
                                               src[3], src[4], src[5], eps);
        float a, sg;
        if (step == 0) {
          a = col;
          sg = (i == start) ? 1.f : 0.f;
          sign_out[i] = sg;
        } else {
          a = acc_out[i] + s * col;
          sg = sign_out[i];
          if (i == c) {
            sg = s;
            sign_out[i] = s;
          }
        }
        acc_out[i] = a;
        if (sg == 0.f) best = max(best, cand_key(a, i));
      }
    }
    if (step == n - 1) break;
    best = warp_max_key(best);
    if (lane == 0) wsh[warp] = best;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long b = warp_max_key(lane < (T >> 5) ? wsh[lane] : 0ull);
      if (G == 1) {
        if (lane == 0) {
          win_key = b;
          if (!kRows && b != 0ull) {
            // one block owns every point: point i's coordinates are at i in
            // shared memory (kPer > 0), or in the cloud
            const int i = key_index(b);
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) {
              win_p[ch] = kPer > 0 ? sh_pts[ch * P + i] : data[ch * nn + i];
            }
          }
        }
      } else {
        unsigned long long* part = slots + (size_t)(step & 1) * G;
        const unsigned long long tag = (unsigned long long)((step + 1) & 0x3f) << kTagShift;
        if (lane == 0) st_relaxed(part + blockIdx.x, b | tag);
        // every block's word, polled until all carry this step's tag: each
        // lane loads its blocks' words together, then checks them
        unsigned long long h[kPoll];
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int r = 0; r < kPoll; ++r) {
            if (lane + 32 * r < G) h[r] = ld_relaxed(part + lane + 32 * r);
          }
#pragma unroll
          for (int r = 0; r < kPoll; ++r) {
            if (lane + 32 * r < G) ready &= (h[r] & kTagMask) == tag;
          }
        } while (!ready);
        unsigned long long mine = 0ull;
#pragma unroll
        for (int r = 0; r < kPoll; ++r) {
          if (lane + 32 * r < G) mine = max(mine, h[r] & ~kTagMask);
        }
        // the coordinates of the lane's best, fetched while the warp reduces
        float p[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (!kRows && mine != 0ull) {
          const int i = key_index(mine);
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) p[ch] = __ldg(data + ch * nn + i);
        }
        const unsigned long long w = warp_max_key(mine);
        if (!kRows) {
          const unsigned hit = __ballot_sync(kFull, mine == w);
          const int from = hit ? __ffs(hit) - 1 : 0;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) p[ch] = __shfl_sync(kFull, p[ch], from);
        }
        if (lane == 0) {
          win_key = w;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) win_p[ch] = p[ch];
        }
      }
    }
    __syncthreads();
    const unsigned long long w = win_key;
    c = key_index(w);
    s = (w & 1ull) ? -1.f : 1.f;
    if (!kRows) {
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) src[ch] = win_p[ch];
    }
  }
  if (kPer > 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = tid + j * stride;
      if (i < n) {
        const unsigned bit = 1u << j;
        acc_out[i] = acc[j];
        sign_out[i] = (vis & bit) ? ((neg & bit) ? -1.f : 1.f) : 0.f;
      }
    }
  }
}

// The mirror-field ("xie") sequential loop (xie mode), which replaces the
// XLA scan dipole_tpu/ops/propagate.py:_xie_greedy_scan (:509-555). It
// keeps a rate vector besides acc: rate starts as the start point's column
// and acc at 0; each step adds rate to acc, picks the unvisited point with
// the largest SIGNED acc (ties to the lowest index), sets its sign to -1 iff
// its acc < 0, and adds sign x its column to rate, in that order. IT is the
// (n, n) transposed xie matrix, so column c of I is the contiguous row c of
// IT. knn (n, k), when k > 0, is the kNN mask in index form: column c is
// multiplied by 1 at the rows knn[c] and by 0 elsewhere, as the JAX scan
// does, without a dense mask. Every update is elementwise with s = +-1, so
// kernel and plain version agree bit for bit in acc and sign. The grid, the
// candidate reduction and the one barrier per step are the greedy's above;
// the sweep count is the same: n sweeps, n - 1 picks, and acc += rate in
// all but the last sweep (n - 1 additions, as the JAX scan's n - 1 steps).
__global__ void __launch_bounds__(kThreads, 1)
xie_greedy_kernel(const float* __restrict__ IT, int n, int start,
                  const int* __restrict__ knn, int k,
                  float* __restrict__ acc, float* __restrict__ rate,
                  float* __restrict__ sign, float* __restrict__ part_v,
                  int* __restrict__ part_i, float* __restrict__ part_a) {
  __shared__ Cand sh[33];
  __shared__ int hits[kMaxK];
  const size_t nn = n;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int c = start;
  float s = 1.f;
  for (int step = 0; step < n; ++step) {
    if (k > 0) {
      for (int m = threadIdx.x; m < k; m += blockDim.x) {
        hits[m] = knn[(size_t)c * k + m];
      }
      __syncthreads();
    }
    const float* col = IT + (size_t)c * nn;
    const bool add = step < n - 1;
    Cand best{-INFINITY, INT_MAX, 0.f};
    for (int i = tid; i < n; i += stride) {
      float v = col[i];
      if (k > 0) {
        bool hit = false;
        for (int m = 0; m < k; ++m) hit |= hits[m] == i;
        v = v * (hit ? 1.f : 0.f);
      }
      float r, a, sg;
      if (step == 0) {
        r = v;
        sg = (i == start) ? 1.f : 0.f;
        sign[i] = sg;
        a = add ? 0.f + r : 0.f;
      } else {
        sg = sign[i];
        if (i == c) {
          sg = s;
          sign[i] = s;
        }
        r = rate[i] + s * v;
        a = acc[i];
        if (add) a = a + r;
      }
      rate[i] = r;
      acc[i] = a;
      if (sg == 0.f && better(a, i, best)) best = Cand{a, i, a};
    }
    if (!add) break;
    best = block_reduce(best, sh);
    const int slot = (step & 1) * gridDim.x;
    if (threadIdx.x == 0) {
      part_v[slot + blockIdx.x] = best.v;
      part_i[slot + blockIdx.x] = best.i;
      part_a[slot + blockIdx.x] = best.a;
    }
    if (gridDim.x > 1) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
    Cand win{-INFINITY, INT_MAX, 0.f};
    for (int q = threadIdx.x; q < (int)gridDim.x; q += blockDim.x) {
      const float v = __ldcg(part_v + slot + q);
      const int i = __ldcg(part_i + slot + q);
      if (better(v, i, win)) win = Cand{v, i, __ldcg(part_a + slot + q)};
    }
    win = block_reduce(win, sh);
    c = win.i;
    s = win.a < 0.f ? -1.f : 1.f;
  }
}

// The SM count of the current device; fails unless the device takes
// cooperative launches. Returns a cudaError_t value.
int coop_sms(int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return coop ? 0 : static_cast<int>(cudaErrorNotSupported);
}

// Fails unless a block of `kernel` (kThreads threads, smem bytes of dynamic
// shared memory) fits on an SM: then a grid of at most one block per SM is
// co-resident, and its blocks may wait on each other. Returns a cudaError_t
// value.
int check_resident(const void* kernel, size_t smem) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return per_sm >= 1 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Blocks of a greedy launch over n points: one up to one_block_max_n
// points, above that one per SM, or fewer for small n.
int grid_blocks(int n, int one_block_max_n, int sms) {
  return n <= one_block_max_n ? 1 : min((n + kThreads - 1) / kThreads, sms);
}

template <bool kRows>
void* owner_kernel(int per) {
  switch (per) {
    case 0: return (void*)greedy_owner_kernel<kRows, 0>;
    case 1: return (void*)greedy_owner_kernel<kRows, 1>;
    case 2: return (void*)greedy_owner_kernel<kRows, 2>;
    case 4: return (void*)greedy_owner_kernel<kRows, 4>;
    case 8: return (void*)greedy_owner_kernel<kRows, 8>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// The most points dipole_greedy runs on one block when not told otherwise,
// in row mode (rows != 0) or column mode.
int dipole_greedy_one_block_max_n(int rows) {
  return rows ? kRowsOneBlockMaxN : kColumnsOneBlockMaxN;
}

// Runs the greedy over n <= 2^24 points from `start`. rows != 0: data is
// the (n, n) row-major interaction matrix; rows == 0: data is the (6, n)
// channel-major cloud [x, y, z, nx, ny, nz] and eps enters the column.
// acc and sign are (n,) outputs. slots: 2 x capacity words, zero on entry.
// The grid: `blocks` if > 0, else one block up to
// dipole_greedy_one_block_max_n(rows) points, above that one block per SM
// or fewer for small n; never more than
// the SMs or `capacity`. The state stays in registers and shared memory
// while n <= the SMs x kPointsPerSM and n <= reg_cap (if reg_cap > 0), else
// in global memory. info receives (blocks, points a thread; 0 for global
// state). Returns a cudaError_t value (0 on success).
int dipole_greedy(const float* data, int n, int start, float eps, int rows,
                  float* acc, float* sign, unsigned long long* slots,
                  int capacity, int reg_cap, int blocks, int* info,
                  cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || start < 0 || start >= n || capacity < 1 || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int e = coop_sms(&sms);
  if (e != 0) return e;
  int g = blocks > 0 ? blocks
                     : grid_blocks(n, dipole_greedy_one_block_max_n(rows), sms);
  g = min(g, min(min(sms, capacity), 32 * kPoll));
  long long cap = (long long)sms * kPointsPerSM;
  if (reg_cap > 0) cap = min(cap, (long long)reg_cap);
  const long long need = ((long long)n + (long long)g * kThreads - 1) /
                         ((long long)g * kThreads);
  int per = 1;
  while (per < need) per <<= 1;
  if (n > cap || per > kMaxPer) per = 0;
  void* kernel = rows ? owner_kernel<true>(per) : owner_kernel<false>(per);
  const size_t smem = (!rows && per > 0) ? sizeof(float) * 6 * per * kThreads : 0;
  // above 48 KB with the static part: set for every size
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  e = check_resident(kernel, smem);
  if (e != 0) return e;
  info[0] = g;
  info[1] = per;
  void* args[] = {(void*)&data, (void*)&n,    (void*)&start, (void*)&eps,
                  (void*)&acc,  (void*)&sign, (void*)&slots};
  err = cudaLaunchCooperativeKernel(kernel, dim3(g), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


// The xie mode: the loop of xie_greedy_kernel over the (n, n) transposed
// xie matrix IT from `start`; knn (n, k) int32 or k == 0 for no mask. acc,
// rate and sign are (n,) outputs; part_v/part_i/part_a are scratch of
// 2 x part_capacity entries each. The grid: one block up to kOneBlockMaxN
// points, above that one block per SM or fewer for small n, never more than
// part_capacity.
// Returns a cudaError_t value (0 on success).
int dipole_xie_greedy(const float* IT, int n, int start, const int* knn,
                      int k, float* acc, float* rate, float* sign,
                      float* part_v, int* part_i, float* part_a,
                      int part_capacity, int* blocks_out,
                      cudaStream_t stream) {
  if (n <= 0 || start < 0 || start >= n || k < 0 || k > kMaxK ||
      (k > 0 && knn == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = (void*)xie_greedy_kernel;
  int sms = 0;
  int e = coop_sms(&sms);
  if (e == 0) e = check_resident(kernel, 0);
  if (e != 0) return e;
  const int blocks = min(grid_blocks(n, kOneBlockMaxN, sms), part_capacity);
  *blocks_out = blocks;
  void* args[] = {(void*)&IT,   (void*)&n,      (void*)&start,
                  (void*)&knn,  (void*)&k,      (void*)&acc,
                  (void*)&rate, (void*)&sign,   (void*)&part_v,
                  (void*)&part_i, (void*)&part_a};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                                dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
