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
// A third mode, the xie mode, runs the mirror-field loop (the XLA scan
// dipole_tpu/ops/propagate.py:_xie_greedy_scan, :509-555) over rows of the
// transposed xie matrix IT, on the same grid, state and exchange. It keeps
// a rate vector beside acc: rate starts as the start point's column and acc
// at 0; each step adds rate to acc, picks the unvisited point with the
// largest SIGNED acc (ties to the lowest index), sets its sign to -1 iff its
// acc < 0, and adds sign x its column to rate, in that order. So it sweeps n
// times, picks n - 1 times, and adds rate to acc in all but the last sweep
// (the JAX scan's n - 1 steps). Column c of I is the contiguous row c of
// IT. With a kNN mask (knn (n, k), k <= 256, in index form) column c is
// multiplied by 1 at the rows knn[c] and by 0 elsewhere, as the JAX scan
// does, without a dense mask: once a step's winner is known, warp 0 of each
// block marks the mask rows that the block owns in a word of shared memory
// per thread (bit j: the thread's j-th point), which each owner reads and
// clears in its next sweep. The marks ride on the barrier that hands the
// winner to the block; no other barrier, and no element compares itself
// with the k rows.
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
//     The xie mode keeps rate in registers too and has no such instance:
//     its n x n matrix keeps n far below what the registers hold, and the
//     entry point refuses more.
//   - a candidate is one 64-bit key whose unsigned order is the greedy's:
//     the bits of |acc| (a non-negative float orders as its bits), then
//     2^24 - index (ties to the lowest index; so n <= 2^24), then the sign
//     of acc. The xie mode orders by the signed acc instead: the float's
//     bits with all of them flipped if it is negative, else with the sign
//     bit set, -0 and +0 as one value (torch.argmax holds them equal).
//     Warps reduce keys with two __reduce_max_sync, not chains of
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
// computes 1-8 column entries a thread a step, and the xie mode updates
// rate and acc, so the column and xie modes' threshold lies lower than the
// row mode's (chip_smoke.py times both sides of each). The block shape
// (1024 threads, against 256 and 512) was measured too (PERF.md).
//
// Batched (greedy_batched_kernel, column mode only; replaces the vmapped
// XLA scan dipole_tpu/ops/propagate.py:_greedy_scan_onthefly_vmapped,
// :213-216, behind the server's micro-batching): B independent clouds in one
// cooperative launch. The clouds lie side by side in one (6, sum N)
// channel-major array; the host plans a block range for each
// (ops/propagate_cuda.greedy_batch_plan: one block up to 4096 points, above
// that blocks in proportion to the points, at most the single launch's
// grid), and each cloud's exchange words start at twice its first block, so
// a block polls only its own cloud's G_b words and the tag arithmetic is
// that of a launch over the cloud alone. A block finds its cloud in a table
// passed by value (__grid_constant__) and runs the same body. All blocks of
// a launch fit on the SMs at once; the host cuts a larger batch into
// several launches. One kPer serves the launch (a template parameter), so
// the batched entry takes only clouds whose state fits in registers, up to
// 8 points a thread: 1.08M points on 132 SMs. The time of a step is latency
// (the exchange), so B clouds side by side cost about what the slowest of
// them costs alone, not B times as much. A lone cloud keeps
// greedy_owner_kernel: launched as a batch of one, the batched kernel took
// 4.7% longer a step at 10000 and at 180000 points (PERF.md).
//
// Arithmetic: compiled with -fmad=false; sqrtf and / are IEEE, and the
// column follows propagate.py:_dipole_column term for term in the plain
// torch version's order (two divides, not the Pallas kernels'
// single-reciprocal form of propagate_pallas.py:73-74). The acc (and xie
// rate) update adds s x col with s = +-1, which is exact before the one
// rounding of the add; the xie mask multiplies by 1 or 0 as the plain
// version does. So the kernel and its plain version agree bit for bit in
// acc and sign. Ties are decided by the keys' total order, which no grid
// changes; so a batched lane is bit-equal in acc and sign to the launch
// over its cloud alone, exact ties across blocks included.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;            // a block, every mode
constexpr int kMaxK = 256;                // kNN mask width of the xie mode
constexpr int kPointsPerSM = 8192;        // state held by one block
constexpr int kMaxPer = kPointsPerSM / kThreads;  // points a thread
// one block up to these many points (measured, PERF.md)
constexpr int kRowsOneBlockMaxN = 5120;
constexpr int kColumnsOneBlockMaxN = 4096;
constexpr int kXieOneBlockMaxN = 4096;
constexpr int kMaxN = 1 << 24;            // the key's index field
constexpr int kPoll = 8;                  // words a lane polls: <= 256 blocks
constexpr int kMaxClouds = 128;           // clouds a batched launch takes
constexpr unsigned kFull = 0xffffffffu;

// The update modes (see the note at the top); the C entry points' `mode`.
enum Mode { kColumns = 0, kRows = 1, kXie = 2 };

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

// The xie mode's key: the same low word, above it the signed acc in an
// unsigned order (negative floats with every bit flipped, the others with
// the sign bit set), -0 taken as +0.
__device__ __forceinline__ unsigned long long xie_key(float a, int i) {
  const unsigned u = __float_as_uint(a == 0.f ? 0.f : a);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) |
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

// Xie mode, masked: marks in hits the rows of knn[c] (column c's kept
// entries) that this block owns, bit j of word t for the point
// blk T + t + j G T; lanes from `first` on, `step` apart.
__device__ __forceinline__ void mark_hits(const int* __restrict__ knn, int k,
                                          int c, int n, int blk, int stride,
                                          unsigned* hits, int first, int step) {
  for (int m = first; m < k; m += step) {
    const int i = knn[(size_t)c * k + m];
    if (i < 0 || i >= n) continue;  // selects nothing, as in the JAX scan
    const int j = i / stride, r = i - j * stride;
    if (r / kThreads == blk) atomicOr(hits + r % kThreads, 1u << j);
  }
}

// The greedy with the state kept by its owner (see the note at the top),
// over one cloud of n points held by G blocks, this block being blk of them
// (blockIdx.x and gridDim.x in a launch over one cloud).
// kPer > 0: kPer points a thread, acc (and the xie rate) in registers,
// visited and sign as bits, coordinates (column mode) in shared memory;
// kPer == 0 (row and column modes only): acc and sign in global memory.
// Blocks of kThreads; slots: the cloud's 2 G words, zero on entry; knn and
// k: the xie mode's mask (k == 0: none); plane: the distance of the
// channel-major cloud's planes (column mode) or of the matrix's rows (row
// and xie modes).
template <int kMode, int kPer>
__device__ __forceinline__ void
greedy_owner(const float* __restrict__ data, int n, int start, float eps,
             const int* __restrict__ knn, int k, float* __restrict__ acc_out,
             float* __restrict__ sign_out, unsigned long long* __restrict__ slots,
             size_t plane, int blk, int G) {
  static_assert(kMode != kXie || kPer > 0, "the xie mode keeps its state in registers");
  constexpr bool kCols = kMode == kColumns;
  extern __shared__ float sh_pts[];  // column mode, kPer > 0: 6 planes of kPer T
  __shared__ unsigned long long wsh[32];
  __shared__ unsigned long long win_key;
  __shared__ float win_p[6];
  __shared__ unsigned hits[kMode == kXie ? kThreads : 1];  // xie mode, masked
  constexpr int kSlots = kPer > 0 ? kPer : 1;
  constexpr int T = kThreads;
  const size_t nn = plane;
  const int stride = G * T;
  const int tid = blk * T + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int P = kPer * T;
  const bool masked = kMode == kXie && k > 0;
  float acc[kSlots], rate[kSlots];
  unsigned vis = 0u, neg = 0u;  // bit j: point j visited; its sign is -1
  if (kCols && kPer > 0) {
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
  if (kCols) {
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) src[ch] = data[ch * nn + c];
  }
  if (masked) {  // the start point's column
    hits[threadIdx.x] = 0u;
    __syncthreads();
    mark_hits(knn, k, c, n, blk, stride, hits, threadIdx.x, T);
    __syncthreads();
  }
  for (int step = 0; step < n; ++step) {
    unsigned long long best = 0ull;
    if constexpr (kPer > 0) {
      // row and xie modes: every entry of the row the thread needs, loaded
      // at once (one after the other, they cost a memory latency each)
      float row[kSlots];
      if (!kCols) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int i = tid + j * stride;
          row[j] = i < n ? data[(size_t)c * nn + i] : 0.f;
        }
      }
      unsigned hw = 0u;
      if (masked) {
        hw = hits[threadIdx.x];
        hits[threadIdx.x] = 0u;
      }
      const bool add = step < n - 1;  // xie: acc += rate, then a pick
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = tid + j * stride;
        if (i < n) {
          const unsigned bit = 1u << j;
          float a;
          if constexpr (kMode == kXie) {
            const float v = masked ? row[j] * ((hw & bit) ? 1.f : 0.f) : row[j];
            const float r = step == 0 ? v : rate[j] + s * v;
            a = step == 0 ? 0.f : acc[j];
            if (add) a = a + r;
            rate[j] = r;
            if (i == c) {
              vis |= bit;
              if (s < 0.f) neg |= bit;
            }
            acc[j] = a;
            if (add && !(vis & bit)) best = max(best, xie_key(a, i));
          } else {
            const float col =
                kCols ? column_entry(sh_pts + j * T + threadIdx.x, P, src[0], src[1],
                                     src[2], src[3], src[4], src[5], eps)
                      : row[j];
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
      }
    } else {
      for (int i = tid; i < n; i += stride) {
        const float col = kCols ? column_entry(data + i, nn, src[0], src[1], src[2],
                                               src[3], src[4], src[5], eps)
                                : data[(size_t)c * nn + i];
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
      unsigned long long w = b;
      if (G == 1) {
        if (lane == 0 && kCols && b != 0ull) {
          // one block owns every point: point i's coordinates are at i in
          // shared memory (kPer > 0), or in the cloud
          const int i = key_index(b);
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            win_p[ch] = kPer > 0 ? sh_pts[ch * P + i] : data[ch * nn + i];
          }
        }
      } else {
        unsigned long long* part = slots + (size_t)(step & 1) * G;
        const unsigned long long tag = (unsigned long long)((step + 1) & 0x3f) << kTagShift;
        if (lane == 0) st_relaxed(part + blk, b | tag);
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
        if (kCols && mine != 0ull) {
          const int i = key_index(mine);
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) p[ch] = __ldg(data + ch * nn + i);
        }
        w = warp_max_key(mine);
        if (kCols) {
          const unsigned hit = __ballot_sync(kFull, mine == w);
          const int from = hit ? __ffs(hit) - 1 : 0;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) p[ch] = __shfl_sync(kFull, p[ch], from);
        }
        if (lane == 0 && kCols) {
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) win_p[ch] = p[ch];
        }
      }
      if (lane == 0) win_key = w;
      // the owners read and cleared last step's marks before the barrier above
      if (masked && w != 0ull) mark_hits(knn, k, key_index(w), n, blk, stride, hits, lane, 32);
    }
    __syncthreads();
    const unsigned long long w = win_key;
    c = key_index(w);
    s = (w & 1ull) ? -1.f : 1.f;
    if (kCols) {
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

template <int kMode, int kPer>
__global__ void __launch_bounds__(kThreads, 1)
greedy_owner_kernel(const float* __restrict__ data, int n, int start, float eps,
                    const int* __restrict__ knn, int k,
                    float* __restrict__ acc_out, float* __restrict__ sign_out,
                    unsigned long long* __restrict__ slots) {
  greedy_owner<kMode, kPer>(data, n, start, eps, knn, k, acc_out, sign_out, slots,
                            (size_t)n, blockIdx.x, gridDim.x);
}

// The clouds of a batched launch (column mode): cloud b's points are
// [off[b], off[b] + n[b]) of the (6, total) channel-major array, its blocks
// [g0[b], g0[b + 1]) of the grid and its exchange words the 2 (g0[b + 1] -
// g0[b]) from slots + 2 g0[b]. Passed by value: every block reads it from
// the constant bank, and the host checks it before the launch.
struct GreedyBatch {
  int count, total;
  int off[kMaxClouds], n[kMaxClouds], start[kMaxClouds], g0[kMaxClouds + 1];
};

// B clouds in one cooperative launch: each block finds its cloud and runs
// the body of a launch over that cloud alone, on its own blocks and its own
// exchange words. Blocks of different clouds never wait on each other, and a
// cloud's blocks finish after its n - 1 steps whatever the others do.
template <int kPer>
__global__ void __launch_bounds__(kThreads, 1)
greedy_batched_kernel(const float* __restrict__ data, float eps,
                      float* __restrict__ acc_out, float* __restrict__ sign_out,
                      unsigned long long* __restrict__ slots,
                      const __grid_constant__ GreedyBatch batch) {
  int b = 0;
  while (b + 1 < batch.count && batch.g0[b + 1] <= (int)blockIdx.x) ++b;
  const int off = batch.off[b], g0 = batch.g0[b];
  greedy_owner<kColumns, kPer>(data + off, batch.n[b], batch.start[b], eps, nullptr, 0,
                               acc_out + off, sign_out + off, slots + 2 * (size_t)g0,
                               (size_t)batch.total, (int)blockIdx.x - g0,
                               batch.g0[b + 1] - g0);
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

template <int kMode>
void* owner_kernel(int per) {
  switch (per) {
    case 0:
      if constexpr (kMode != kXie) return (void*)greedy_owner_kernel<kMode, 0>;
      return nullptr;
    case 1: return (void*)greedy_owner_kernel<kMode, 1>;
    case 2: return (void*)greedy_owner_kernel<kMode, 2>;
    case 4: return (void*)greedy_owner_kernel<kMode, 4>;
    case 8: return (void*)greedy_owner_kernel<kMode, 8>;
  }
  return nullptr;
}

void* owner_kernel(int mode, int per) {
  switch (mode) {
    case kColumns: return owner_kernel<kColumns>(per);
    case kRows: return owner_kernel<kRows>(per);
    case kXie: return owner_kernel<kXie>(per);
  }
  return nullptr;
}

template <int kPer>
void* batched_kernel() {
  return (void*)greedy_batched_kernel<kPer>;
}

void* batched_kernel(int per) {
  switch (per) {
    case 1: return batched_kernel<1>();
    case 2: return batched_kernel<2>();
    case 4: return batched_kernel<4>();
    case 8: return batched_kernel<8>();
  }
  return nullptr;
}

// Sets the kernel's dynamic shared memory, checks that a block fits on an
// SM and launches a grid of g blocks cooperatively. Returns a cudaError_t
// value.
int launch_coop(void* kernel, int g, size_t smem, void** args, cudaStream_t stream) {
  // above 48 KB with the static part: set for every size
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = check_resident(kernel, smem);
  if (e != 0) return e;
  err = cudaLaunchCooperativeKernel(kernel, dim3(g), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most points dipole_greedy runs on one block when not told otherwise,
// in the given mode (0 columns, 1 rows, 2 xie; Mode above).
int dipole_greedy_one_block_max_n(int mode) {
  return mode == kColumns ? kColumnsOneBlockMaxN
                          : mode == kRows ? kRowsOneBlockMaxN : kXieOneBlockMaxN;
}

// Runs the greedy over n <= 2^24 points from `start` in the given mode:
// rows (1), data the (n, n) row-major interaction matrix; columns (0),
// data the (6, n) channel-major cloud [x, y, z, nx, ny, nz], eps entering
// the column; xie (2), data the (n, n) transposed xie matrix, knn (n, k)
// int32 its mask (k == 0: none, k <= 256). acc and sign are (n,) outputs.
// slots: 2 x capacity words, zero on entry. The grid: `blocks` if > 0,
// else one block up to dipole_greedy_one_block_max_n(mode) points, above
// that one block per SM or fewer for small n; never more than the SMs or
// `capacity`. The state stays in registers and shared memory while n <=
// the SMs x kPointsPerSM and n <= reg_cap (if reg_cap > 0), else in global
// memory; the xie mode refuses the latter. info receives (blocks, points a
// thread; 0 for global state). Returns a cudaError_t value (0 on success).
int dipole_greedy(const float* data, int n, int start, float eps, int mode,
                  const int* knn, int k, float* acc, float* sign,
                  unsigned long long* slots, int capacity, int reg_cap,
                  int blocks, int* info, cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || start < 0 || start >= n || capacity < 1 || blocks < 0 ||
      mode < kColumns || mode > kXie || k < 0 || k > kMaxK ||
      (k > 0 && (mode != kXie || knn == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int e = coop_sms(&sms);
  if (e != 0) return e;
  int g = blocks > 0 ? blocks
                     : grid_blocks(n, dipole_greedy_one_block_max_n(mode), sms);
  g = min(g, min(min(sms, capacity), 32 * kPoll));
  long long cap = (long long)sms * kPointsPerSM;
  if (reg_cap > 0) cap = min(cap, (long long)reg_cap);
  const long long need = ((long long)n + (long long)g * kThreads - 1) /
                         ((long long)g * kThreads);
  int per = 1;
  while (per < need) per <<= 1;
  if (n > cap || per > kMaxPer) per = 0;
  if (mode == kXie && per == 0) return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = owner_kernel(mode, per);
  const size_t smem =
      (mode == kColumns && per > 0) ? sizeof(float) * 6 * per * kThreads : 0;
  info[0] = g;
  info[1] = per;
  void* args[] = {(void*)&data, (void*)&n,   (void*)&start, (void*)&eps,
                  (void*)&knn,  (void*)&k,   (void*)&acc,   (void*)&sign,
                  (void*)&slots};
  return launch_coop(kernel, g, smem, args, stream);
}

// The most clouds dipole_greedy_batched takes in one launch.
int dipole_greedy_batched_max_clouds() { return kMaxClouds; }

// Runs the column-mode greedy over `count` clouds in one cooperative launch.
// data: the clouds side by side, channel-major (6, total); cloud b is the
// points [offs[b], offs[b] + ns[b]), starts at starts[b] and takes
// blocks[b] blocks of the grid, in that order; acc and sign (total,) receive
// each cloud's outputs at its points. per (1, 2, 4 or 8) is the points a
// thread of every cloud, its state in registers: each cloud needs ns[b] <=
// per x blocks[b] x 1024. The blocks together may not exceed the SMs, so
// that every block is resident. slots: 2 x capacity words, zero on entry,
// capacity >= the blocks. Each cloud's acc and sign are bit-equal to
// dipole_greedy's on that cloud alone, on any grid: the same column
// entries, the same updates, the same total order of the keys. Returns a
// cudaError_t value (0 on success).
int dipole_greedy_batched(const float* data, int total, const int* offs, const int* ns,
                          const int* starts, const int* blocks, int count, int per,
                          float eps, float* acc, float* sign,
                          unsigned long long* slots, int capacity,
                          cudaStream_t stream) {
  void* kernel = batched_kernel(per);
  if (count < 1 || count > kMaxClouds || total < 1 || capacity < 1 || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const int e = coop_sms(&sms);
  if (e != 0) return e;
  GreedyBatch batch;
  batch.count = count;
  batch.total = total;
  int g = 0;
  for (int b = 0; b < count; ++b) {
    const int n = ns[b];
    if (n < 1 || offs[b] < 0 || offs[b] > total - n || starts[b] < 0 || starts[b] >= n ||
        blocks[b] < 1 || (long long)n > (long long)per * blocks[b] * kThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    batch.off[b] = offs[b];
    batch.n[b] = n;
    batch.start[b] = starts[b];
    batch.g0[b] = g;
    g += blocks[b];
    if (g > min(min(sms, capacity), 32 * kPoll)) return static_cast<int>(cudaErrorInvalidValue);
  }
  batch.g0[count] = g;
  const size_t smem = sizeof(float) * 6 * per * kThreads;
  void* args[] = {(void*)&data, (void*)&eps,   (void*)&acc,
                  (void*)&sign, (void*)&slots, (void*)&batch};
  return launch_coop(kernel, g, smem, args, stream);
}

}  // extern "C"
