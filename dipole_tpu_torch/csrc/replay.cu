// The in-order replay: T propagation orders advanced in lock-step over one
// interaction matrix.
//
// Replaces: the XLA scan dipole_tpu/ops/propagate.py:_in_order_scan
// (:649-703; no Pallas twin), which carries xie_propagation_in_order and the
// BFS-tree voting. Step k, for every order t: idx = orders[t, k],
//   inter = sum_j I[idx, j] colw[j] mask(idx, j) w[t, j],
//   w[t, idx] = inter < 0 ? -1 : 1,  inter_rec[t, idx] = inter.
// colw (points_weight) is optional; mask(i, j) = [i in knn[j]], the kNN mask
// in index form, is optional too. An index may repeat in an order: a later
// visit overwrites w and inter_rec. The diffuse re-vote after the loop is a
// matrix product and stays in torch (ops/propagate.py).
//
// What bounds it on an H100: taken one step at a time, latency: every step
// waits for the previous decision, a barrier a step (the first design, one
// thread-block cluster per order, paid 2.6 us a step). Blocked as below, the
// floor is the bytes: each order's S rows of N floats read once, T S N x 4 B
// in all (10.8 GB, 3.2 ms at 3.35 TB/s for T = 3 at 30k); as built, the
// decision pass's one warp per order and the launches between the passes
// take about as long as the bulk pass (PERF.md).
//
// Design, unmasked: the order is known before the replay starts and w is 0
// except where the order has already been, so the sums of B steps can be
// taken at once from w as it stands at the block's start, and corrected
// inside the block:
//   inter_k = base_k + sum_{m < k} A[k, m] delta_m,
//   base_k = sum_j I[o_k, j] colw[j] w_start[j],  A[k, m] = I[o_k, o_m] colw[o_m],
// where delta_m = w_new - w_old at step m's index (0, +-1 or +-2: the change,
// not the new value, keeps repeated indices right). Each order is a lane
// (replay_lanes), and one blocked loop runs up to kMaxLanes lanes: the T
// orders of one cloud (dipole_replay), or the orders of B clouds, each over
// its own matrix, passed by a pointer table (dipole_replay_batched, unmasked
// and unweighted as the vmapped XLA scan it replaces,
// dipole_tpu/ops/propagate.py:_in_order_scan_vmapped, :861-863, behind the
// server's micro-batching). Two launches a block of B steps, on the
// caller's stream:
//   replay_bulk_kernel  base for the B steps of every running lane at once:
//                       its B rows cut into the lane's chunks, all lanes in
//                       one grid over every SM, float64 partial sums (exact
//                       products, w in {0, +-1}); streams the rows once, the
//                       bandwidth-bound part. Each chunk also hands over the
//                       entries of A whose column it holds, read again from
//                       the caches rather than gathered later from HBM;
//   replay_seq_kernel   one block per lane: sums the partials in a fixed
//                       order, copies A into shared memory, and one warp
//                       takes the B decisions, 32 steps at a time (lane l
//                       holds step 32 q + l): inside such a sub-block a step
//                       is one broadcast by shuffles and one update a lane,
//                       with no barrier; after it its 32 changes go into
//                       the later steps' bases. It writes w and inter_rec
//                       for the last visit of each index.
// The kernel boundary is the only barrier: S / B x 2 launches instead of S
// barriers. B = kBlockSteps = 128, measured against 32, 64 and 256 (PERF.md);
// the scratch the passes share is sized by dipole_replay_scratch. A lone
// cloud of T = 3 orders keeps 3 warps of the card busy in its decision
// pass; a batch of 8 keeps 24, in the same time. Lanes whose orders are
// shorter drop out of the loop when they end. Each lane takes its cloud's
// chunk plan (bulk_chunks with the cloud's T), so its sums run in the same
// order whatever lanes share the loop, and a batched lane's w and inter are
// bit-equal to the replay of its cloud alone.
// Masked, only the ~k sources j with idx in knn[j] enter a row's sum, so
// each order runs in one warp over the reverse kNN lists (rev_ptr/rev_src:
// the sources of each target, ascending), with no barrier at all.
//
// Determinism: w is 0 or +-1, so once I colw is rounded in float32 every
// product (and every A delta) is exact in float64; sums run in float64 in a
// fixed order. The plain torch version sums in float64 in its own order, so
// kernel and plain version take the same decisions unless |inter| falls
// below ~1e-12 of the sum of |I w|, and agree in inter to ~1e-15 relative.

#include "common.cuh"

namespace {

constexpr int kBulkThreads = 256;
constexpr int kSeqThreads = 512;
constexpr int kBlockSteps = 128;  // B, measured (PERF.md)
constexpr int kQ = kBlockSteps / 32;  // steps a lane holds in the decision pass
constexpr int kMaxChunks = 64;
constexpr int kMaxLanes = 48;  // lanes of one blocked loop (ReplayLanes)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float entry(const float* __restrict__ row,
                                       const float* __restrict__ colw, int j) {
  const float v = row[j];
  return colw ? v * colw[j] : v;
}

__global__ void __launch_bounds__(32)
replay_masked_kernel(const float* __restrict__ I, int n, int steps,
                     const int* __restrict__ orders, int T,
                     const float* __restrict__ colw,
                     const int* __restrict__ rev_ptr,
                     const int* __restrict__ rev_src, float* __restrict__ w,
                     double* __restrict__ inter) {
  const int t = blockIdx.x;
  if (t >= T) return;
  const int lane = threadIdx.x;
  const size_t nn = n;
  float* wt = w + t * nn;
  for (int k = 0; k < steps; ++k) {
    const int idx = orders[t * (size_t)steps + k];
    const float* row = I + (size_t)idx * nn;
    double v = 0.0;
    for (int e = rev_ptr[idx] + lane; e < rev_ptr[idx + 1]; e += 32) {
      const int j = rev_src[e];
      v += (double)entry(row, colw, j) * (double)wt[j];
    }
    v = warp_sum(v);
    if (lane == 0) {
      inter[t * nn + idx] = v;
      wt[idx] = v < 0.0 ? -1.f : 1.f;
    }
    __syncwarp();
  }
}

constexpr int kPairs = kBlockSteps * (kBlockSteps - 1) / 2;  // entries of A

// Column m of the block's correction A (A[k, m] = I[o_k, o_m] colw[o_m] for
// k > m) starts at tri_col(m) + m + 1: the lanes' k of one step are
// neighbours in memory.
__device__ __forceinline__ int tri_col(int m) {
  constexpr int B = kBlockSteps;
  return m * (B - 1) - m * (m - 1) / 2 - m - 1;
}

// One block of the bulk pass of one order, ot its indices from the block
// of steps' first: sums chunk c of row o_m = ot[m] against the order's w as
// it stands into part[m chunks + c], and, while the chunk is in the caches,
// picks the entries A[m, m'] (m' < m) whose column o_m' lies in it into
// tri[tri_col(m') + m].
__device__ __forceinline__ void
bulk_block(const float* __restrict__ I, int n, const int* __restrict__ ot, int c,
           int m, int chunks, const float* __restrict__ colw,
           const float* __restrict__ wt, double* __restrict__ part,
           float* __restrict__ tri) {
  __shared__ double sh[kBulkThreads / 32];
  const size_t nn = n;
  const float* row = I + (size_t)ot[m] * nn;
  const int per = (n + chunks - 1) / chunks;
  const int j0 = c * per, j1 = min(n, j0 + per);
  double p = 0.0;
#pragma unroll 4
  for (int j = j0 + threadIdx.x; j < j1; j += kBulkThreads) {
    p += (double)entry(row, colw, j) * (double)wt[j];
  }
  p = warp_sum(p);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = p;
  for (int mm = threadIdx.x; mm < m; mm += kBulkThreads) {
    const int j = ot[mm];
    if (j >= j0 && j < j1) {
      tri[tri_col(mm) + m] = entry(row, colw, j);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int q = 0; q < kBulkThreads / 32; ++q) v += sh[q];
    part[m * chunks + c] = v;
  }
}

// The decisions of the steps [k0, k0 + bp) of one order, B = 32 kQ steps at
// most, ot its indices from k0, part and tri its bulk pass's: the bases
// from the partials and A into shared memory, then one warp, lane l holding
// steps l, l + 32, ..., 32 steps (a sub-block) at a time: within it every
// step is one broadcast and one update a lane; after it its 32 changes go
// into the later steps' bases. Writes the order's w (wt) and inter (it) of
// each index at its last visit in the block.
__device__ __forceinline__ void
seq_block(const int* __restrict__ ot, int bp, int chunks,
          const double* __restrict__ part, const float* __restrict__ tri,
          float* __restrict__ wt, double* __restrict__ it) {
  extern __shared__ double base[];  // [B], then A [kPairs], ids [B], w0 [B]
  constexpr int B = kBlockSteps;
  float* A = reinterpret_cast<float*>(base + B);
  int* ids = reinterpret_cast<int*>(A + kPairs);
  float* w0 = reinterpret_cast<float*>(ids + B);
  for (int m = threadIdx.x; m < bp; m += kSeqThreads) {
    const int id = ot[m];
    ids[m] = id;
    w0[m] = wt[id];
    const double* pm = part + (size_t)m * chunks;
    double b = 0.0;
    for (int c = 0; c < chunks; ++c) b += pm[c];
    base[m] = b;
  }
  // kPairs is a multiple of 4 and both ends 16-byte aligned (B = 32 kQ)
  const float4* tt = reinterpret_cast<const float4*>(tri);
#pragma unroll 4
  for (int e = threadIdx.x; e < kPairs / 4; e += kSeqThreads) {
    reinterpret_cast<float4*>(A)[e] = tt[e];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double b[kQ];   // base, then inter, of step 32 q + lane
  float wc[kQ];   // w at that step's index as the step finds it
  int id[kQ];
  unsigned last = 0u;  // bit q: step 32 q + lane is its index's last visit
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m = 32 * q + lane;
    const bool in = m < bp;
    b[q] = in ? base[m] : 0.0;
    wc[q] = in ? w0[m] : 0.f;
    id[q] = in ? ids[m] : -1;
    if (in) last |= 1u << q;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m0 = 32 * q;
    if (m0 >= bp) break;
    const int top = min(32, bp - m0);
    float dq = 0.f;  // the change this lane's step made
    for (int l = 0; l < top; ++l) {
      const double x = __shfl_sync(kFull, b[q], l);
      const float wold = __shfl_sync(kFull, wc[q], l);
      const int im = __shfl_sync(kFull, id[q], l);
      const float wn = x < 0.0 ? -1.f : 1.f;
      const float d = wn - wold;
      if (lane == l) dq = d;
      if (lane > l && lane < top) {
        if (d != 0.f) b[q] += (double)A[tri_col(m0 + l) + m0 + lane] * (double)d;
        if (id[q] == im) wc[q] = wn;
      } else if (lane < l && id[q] == im) {
        last &= ~(1u << q);
      }
    }
    if (q + 1 < kQ && m0 + 32 < bp) {
      for (int l = 0; l < top; ++l) {
        const float d = __shfl_sync(kFull, dq, l);
        const int im = __shfl_sync(kFull, id[q], l);
        const float wn = __shfl_sync(kFull, b[q], l) < 0.0 ? -1.f : 1.f;
        const int col = tri_col(m0 + l);
        bool again = false;
#pragma unroll
        for (int q2 = q + 1; q2 < kQ; ++q2) {
          if (32 * q2 + lane < bp) {
            if (d != 0.f) b[q2] += (double)A[col + 32 * q2 + lane] * (double)d;
            if (id[q2] == im) {
              wc[q2] = wn;
              again = true;
            }
          }
        }
        if (__any_sync(kFull, again) && lane == l) last &= ~(1u << q);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (last & (1u << q)) {
      wt[id[q]] = b[q] < 0.0 ? -1.f : 1.f;
      it[id[q]] = b[q];
    }
  }
}

// One lane of a replay: an order of `steps` indices over the (n, n)
// row-major matrix I of a cloud replayed with T orders, colw (n,) or null,
// w (n) and inter (n) its outputs.
struct Lane {
  const float* I;
  int n;
  const int* order;
  int steps, T;
  const float* colw;
  float* w;
  double* inter;
};

// The lanes of one block of steps: lane l is still running (its order is
// longer than the block's first step). Its bulk blocks are [first[l],
// first[l + 1]) of the bulk grid, c = the block's offset % chunks[l], m =
// offset / chunks[l]; its decision block is blockIdx.x = l; its scratch is
// lane scratch[l] of part and tri. Passed by value to both kernels
// (__grid_constant__).
struct ReplayLanes {
  int count;
  int first[kMaxLanes + 1];
  int n[kMaxLanes], chunks[kMaxLanes], bp[kMaxLanes], scratch[kMaxLanes];
  const float* I[kMaxLanes];
  const float* colw[kMaxLanes];
  const int* orders[kMaxLanes];  // the order's indices from the block's first step
  float* w[kMaxLanes];
  double* inter[kMaxLanes];
};

__global__ void __launch_bounds__(kBulkThreads)
replay_bulk_kernel(const __grid_constant__ ReplayLanes lanes, double* __restrict__ part,
                   float* __restrict__ tri) {
  int l = 0;
  while (l + 1 < lanes.count && lanes.first[l + 1] <= (int)blockIdx.x) ++l;
  const int at = (int)blockIdx.x - lanes.first[l], chunks = lanes.chunks[l];
  const size_t s = lanes.scratch[l];
  bulk_block(lanes.I[l], lanes.n[l], lanes.orders[l], at % chunks, at / chunks, chunks,
             lanes.colw[l], lanes.w[l], part + s * kBlockSteps * kMaxChunks,
             tri + s * kPairs);
}

__global__ void __launch_bounds__(kSeqThreads, 1)
replay_seq_kernel(const __grid_constant__ ReplayLanes lanes,
                  const double* __restrict__ part, const float* __restrict__ tri) {
  const int l = blockIdx.x;
  const size_t s = lanes.scratch[l];
  seq_block(lanes.orders[l], lanes.bp[l], lanes.chunks[l],
            part + s * kBlockSteps * kMaxChunks, tri + s * kPairs, lanes.w[l],
            lanes.inter[l]);
}

// Chunks of a row in the bulk pass of a block of bp steps of T orders over
// n columns: about four bulk blocks an SM, chunks of at least 1024 columns.
// A lane takes its cloud's T, whatever lanes share its launches, so its
// chunks, and with them the order of its sums, do not depend on the batch.
int bulk_chunks(int sms, int T, int bp, int n) {
  const int chunks = (4 * sms + T * bp - 1) / (T * bp);
  return max(1, min(chunks, min(kMaxChunks, (n + 1023) / 1024)));
}

int seq_smem() {
  return kBlockSteps * sizeof(double) + kPairs * sizeof(float) +
         2 * kBlockSteps * sizeof(int);
}

// Replays L <= kMaxLanes lanes in one blocked loop: for each block of
// kBlockSteps steps one bulk launch over every running lane's rows and one
// decision launch of a block per running lane; a lane whose order has ended
// drops out. part and tri: the scratch of dipole_replay_scratch(L).
cudaError_t replay_lanes(const Lane* lane, int L, double* part, float* tri,
                         cudaStream_t stream) {
  constexpr int B = kBlockSteps;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int smem = seq_smem();
  e = cudaFuncSetAttribute(replay_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  int max_steps = 0;
  for (int l = 0; l < L; ++l) max_steps = max(max_steps, lane[l].steps);
  ReplayLanes lanes;
  for (int k0 = 0; k0 < max_steps; k0 += B) {
    int count = 0, blocks = 0;
    for (int l = 0; l < L; ++l) {
      const Lane& a = lane[l];
      if (a.steps <= k0) continue;
      const int bp = min(B, a.steps - k0);
      const int chunks = bulk_chunks(sms, a.T, bp, a.n);
      lanes.first[count] = blocks;
      lanes.n[count] = a.n;
      lanes.chunks[count] = chunks;
      lanes.bp[count] = bp;
      lanes.scratch[count] = l;
      lanes.I[count] = a.I;
      lanes.colw[count] = a.colw;
      lanes.orders[count] = a.order + k0;
      lanes.w[count] = a.w;
      lanes.inter[count] = a.inter;
      blocks += chunks * bp;
      ++count;
    }
    lanes.first[count] = blocks;
    lanes.count = count;
    replay_bulk_kernel<<<blocks, kBulkThreads, 0, stream>>>(lanes, part, tri);
    replay_seq_kernel<<<count, kSeqThreads, smem, stream>>>(lanes, part, tri);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch of an unmasked replay of T lanes (orders, over all clouds):
// part_doubles float64 and tri_floats float32 entries, for the kMaxLanes
// lanes that run at once at most. Returns 0.
int dipole_replay_scratch(int T, long long* part_doubles, long long* tri_floats) {
  const long long lanes = min(T, kMaxLanes);
  *part_doubles = lanes * kBlockSteps * kMaxChunks;
  *tri_floats = lanes * kPairs;
  return 0;
}

// Replays T orders (T, steps) int32 over the (n, n) row-major matrix I.
// colw (n,) or null. rev_ptr (n + 1,) and rev_src (n k,) int32 select the
// masked mode (one warp per order); null, the unmasked one: the orders are
// lanes of the blocked loop (kMaxLanes at a time), with part and tri
// scratch of the sizes dipole_replay_scratch(T) gives. w (T, n) float32 and
// inter (T, n) float64 must be zero on entry and hold the decisions and the
// recorded interactions on return. Returns a cudaError_t value.
int dipole_replay(const float* I, int n, const int* orders, int T, int steps,
                  const float* colw, const int* rev_ptr, const int* rev_src,
                  double* part, float* tri, float* w, double* inter,
                  cudaStream_t stream) {
  if (n <= 0 || T <= 0 || T > 65535 || steps < 0 ||
      (rev_ptr == nullptr) != (rev_src == nullptr) ||
      (rev_ptr == nullptr && (part == nullptr || tri == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  if (rev_ptr != nullptr) {
    replay_masked_kernel<<<T, 32, 0, stream>>>(I, n, steps, orders, T, colw,
                                               rev_ptr, rev_src, w, inter);
    return static_cast<int>(cudaGetLastError());
  }
  Lane lanes[kMaxLanes];
  for (int t0 = 0; t0 < T; t0 += kMaxLanes) {
    const int L = min(kMaxLanes, T - t0);
    for (int l = 0; l < L; ++l) {
      const size_t t = t0 + l;
      lanes[l] = {I, n, orders + t * steps, steps, T, colw, w + t * n, inter + t * n};
    }
    const cudaError_t e = replay_lanes(lanes, L, part, tri, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Replays L lanes, unmasked and unweighted, in blocked loops of kMaxLanes
// lanes: lane l is one order of one cloud, orders[l] (steps[l] int32
// indices) over the (ns[l], ns[l]) row-major matrix Is[l], of a cloud of
// Ts[l] orders; ws[l] (ns[l] float32) and inters[l] (ns[l] float64), zero on
// entry, receive its decisions and recorded interactions. part and tri: the
// scratch of dipole_replay_scratch(L). Each lane's w and inter are
// bit-equal to dipole_replay's on its cloud alone: the same chunks, sums in
// the same order, the same decisions. Returns a cudaError_t value.
int dipole_replay_batched(const float* const* Is, const int* ns,
                          const int* const* orders, const int* steps, const int* Ts,
                          float* const* ws, double* const* inters, int L,
                          double* part, float* tri, cudaStream_t stream) {
  if (L < 1 || part == nullptr || tri == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < L; ++l) {
    if (Is[l] == nullptr || ns[l] < 1 || steps[l] < 0 || Ts[l] < 1 ||
        (steps[l] > 0 && orders[l] == nullptr) || ws[l] == nullptr ||
        inters[l] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Lane lanes[kMaxLanes];
  for (int g = 0; g < L; g += kMaxLanes) {
    const int count = min(kMaxLanes, L - g);
    for (int l = 0; l < count; ++l) {
      const int b = g + l;
      lanes[l] = {Is[b], ns[b], orders[b], steps[b], Ts[b], nullptr, ws[b], inters[b]};
    }
    const cudaError_t e = replay_lanes(lanes, count, part, tri, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
