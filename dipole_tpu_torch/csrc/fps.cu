// Batched masked farthest-point sampling: for each patch b, m selections
// starting at starts[b]. The running distance of a valid point starts at
// its d2 to the start and of an invalid point at -1; each step picks the
// largest running distance (lowest index on ties), then takes the minimum
// with every point's d2 to the pick. Invalid points are never chosen while
// a valid one has a positive distance. d2 = dx*dx + dy*dy + dz*dz with
// dx = x - x_pick. Output (B, m) int32, column 0 the start.
//
// Replaces: dipole_tpu/ops/neighbors_pallas.py:_fps_batch_kernel (via
// fps_masked_batch_pallas), the two pooling stages of every PointCNN
// forward (pointcnn.py:319-338); decisions as pointcnn._fps_masked
// (:183-200) mapped over the batch.
//
// What bounds it on an H100: latency. m - 1 dependent steps, each an argmax
// over the patch; the work, B (m - 1) N pairs of ~10 operations, is small
// ((256, 512, m 308): 4e8 operations, 6 us at 67 TFLOP/s). 256 patches
// fill fewer than the card's 528 warp schedulers, so a step costs what one
// warp issues and waits for.
//
// Design: a block per patch of `warps` warps (the wrapper's plan:
// ceil(n / 512), so one warp up to 512 points, 16 at the limit of 8192),
// each lane holding P points in registers (P even, 2..16, the least that
// covers n: no dead slots to sweep at the forward's 308 rows). Point j lies
// with warp j / (32 P), slot (j mod 32 P) / 32, lane j mod 32. A step: each
// lane updates its running distances to the last pick, one stage of the
// formula at a time over all P slots (so the slots' chains interleave),
// takes their maximum by a tree and the lowest slot that holds it by a
// chain of selects that runs under the warp's reduction; the warp reduces an
// order-preserving 32-bit key of the value with __reduce_max_sync and the
// index among the lanes that hold it with __reduce_min_sync: the largest
// value, then the lowest index. Several warps then exchange their (key,
// index) through shared memory, double-buffered by step parity so one
// __syncthreads a step suffices; one warp needs no barrier at all. Every
// lane reads the pick's coordinates with one broadcast float4 load from the
// patch's copy of its points in shared memory.
//
// A start outside [0, n) traps before any point is read: the launch fails
// ("unspecified launch failure" at the stream's next synchronisation). The
// wrapper does not read the starts back from the card, which would stall
// the host twice a forward; the port also checks starts where it makes
// them, on the host (models/pointcnn.py), for an early, readable error. A
// device-side assert() in place of the trap made the kernel ~19% slower at
// 512 points on an H100 (PERF.md).
//
// Arithmetic: -fmad=false, so the distances and hence every decision are
// bit-equal to the plain torch version (ops/neighbors.py).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxPer = 16;                              // points a lane
constexpr int kMaxPoints = 32 * kMaxWarps * kMaxPer;     // 8192

// A float's order as an unsigned integer: a < b iff key(a) < key(b) (no
// NaN; -0 comes before +0, and no distance here is -0).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int P>
__global__ void __launch_bounds__(32 * kMaxWarps)
fps_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ valid,
           int n, int m, const int* __restrict__ starts, int* __restrict__ out) {
  extern __shared__ float4 pts[];              // the patch's points
  __shared__ unsigned red_key[2][kMaxWarps];
  __shared__ unsigned red_j[2][kMaxWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float* Pb = pos + (size_t)b * n * 3;
  const unsigned char* V = valid + (size_t)b * n;
  int* O = out + (size_t)b * m;

  int c = starts[b];
  if (c < 0 || c >= n) __trap();             // the same for the whole block
  const int base = wid * 32 * P + lane;        // slot q holds base + 32 q
  float x[P], y[P], z[P], mind[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = base + 32 * q;
    x[q] = y[q] = z[q] = 0.f;
    if (j < n) {
      x[q] = Pb[3 * j];
      y[q] = Pb[3 * j + 1];
      z[q] = Pb[3 * j + 2];
      pts[j] = make_float4(x[q], y[q], z[q], 0.f);
    }
  }
  if (warps > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  float4 w = pts[c];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = base + 32 * q;
    const float dx = x[q] - w.x, dy = y[q] - w.y, dz = z[q] - w.z;
    const float d = dx * dx + dy * dy + dz * dz;
    mind[q] = j < n ? (V[j] ? d : -1.f) : -INFINITY;   // out of range: never the max
  }
  if (threadIdx.x == 0) O[0] = c;

  int par = 0;
  for (int i = 1; i < m; ++i) {
    // the lane's largest running distance by a tree; its lowest slot by a
    // chain of selects, which runs while the warp reduces the key
    float t[P];
#pragma unroll
    for (int q = 0; q < P; ++q) t[q] = mind[q];
#pragma unroll
    for (int s = 1; s < P; s *= 2) {
#pragma unroll
      for (int q = 0; q + s < P; q += 2 * s) t[q] = fmaxf(t[q], t[q + s]);
    }
    int bq = P - 1;
#pragma unroll
    for (int q = P - 2; q >= 0; --q) bq = mind[q] == t[0] ? q : bq;
    const unsigned key = order_key(t[0]);
    unsigned kmax = __reduce_max_sync(0xffffffffu, key);
    unsigned jmin = __reduce_min_sync(
        0xffffffffu, key == kmax ? (unsigned)(base + 32 * bq) : UINT_MAX);
    if (warps > 1) {
      if (lane == 0) {
        red_key[par][wid] = kmax;
        red_j[par][wid] = jmin;
      }
      __syncthreads();
      unsigned k2 = 0u, j2 = UINT_MAX;
      if (lane < warps) {
        k2 = red_key[par][lane];
        j2 = red_j[par][lane];
      }
      kmax = __reduce_max_sync(0xffffffffu, k2);
      jmin = __reduce_min_sync(0xffffffffu, k2 == kmax ? j2 : UINT_MAX);
      par ^= 1;
    }
    c = static_cast<int>(jmin);
    if (threadIdx.x == 0) O[i] = c;
    w = pts[c];
    // stage by stage over the slots: written slot by slot, ptxas reuses two
    // registers for every slot and serialises the P chains of 8 operations
    float dx[P], dy[P], dz[P];
#pragma unroll
    for (int q = 0; q < P; ++q) dx[q] = x[q] - w.x;
#pragma unroll
    for (int q = 0; q < P; ++q) dy[q] = y[q] - w.y;
#pragma unroll
    for (int q = 0; q < P; ++q) dz[q] = z[q] - w.z;
#pragma unroll
    for (int q = 0; q < P; ++q) dx[q] = dx[q] * dx[q];
#pragma unroll
    for (int q = 0; q < P; ++q) dy[q] = dy[q] * dy[q];
#pragma unroll
    for (int q = 0; q < P; ++q) dz[q] = dz[q] * dz[q];
#pragma unroll
    for (int q = 0; q < P; ++q) dx[q] = dx[q] + dy[q];
#pragma unroll
    for (int q = 0; q < P; ++q) mind[q] = fminf(mind[q], dx[q] + dz[q]);
  }
}

template <int P>
int launch(const float* pos, const unsigned char* valid, int batch, int n,
           int m, const int* starts, int warps, int* out, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * n;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float4) * kMaxPoints));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<P><<<batch, 32 * warps, smem, stream>>>(pos, valid, n, m, starts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dipole_fps_max_points() { return kMaxPoints; }

// pos (B, n, 3) float32, valid (B, n) bool (one byte each), starts (B,)
// int32, all on the device; out (B, m) int32. 1 <= n <= kMaxPoints; warps
// (1..16) and per_lane (2..16, even) with 32 warps per_lane >= n: the
// wrapper's plan. Returns cudaGetLastError().
int dipole_fps(const float* pos, const unsigned char* valid, int batch, int n,
               int m, const int* starts, int warps, int per_lane, int* out,
               cudaStream_t stream) {
  if (n <= 0 || n > kMaxPoints || warps < 1 || warps > kMaxWarps ||
      32 * warps * per_lane < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || m <= 0) return 0;
  switch (per_lane) {
    case 2: return launch<2>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 4: return launch<4>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 6: return launch<6>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 8: return launch<8>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 10: return launch<10>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 12: return launch<12>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 14: return launch<14>(pos, valid, batch, n, m, starts, warps, out, stream);
    case 16: return launch<16>(pos, valid, batch, n, m, starts, warps, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
