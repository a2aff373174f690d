// Dipole potential at target points: phi_t = sum_s p_s . R / |R|^3 with
// R = x_s - x_t, no eps (the lattice potential of the global sign fix).
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_potential_kernel (the Pallas
// TPU kernel behind potential_pallas, reached from fields.potential): the
// sign fix of every pipeline (fields.measure_mean_potential, 1000 lattice
// targets), once a call and 24 times in a graph_dipole run (a patch each).
//
// What bounds it on an H100: instruction issue. 1000 targets x 180000
// sources are 1.8e8 pairs of 17 operations as counted for the bound (0.046
// ms at 67 TFLOP/s fp32) against 24 bytes a source, read once per block
// from L2. One target a thread with an IEEE root and divide a pair issued
// ~69 instructions a pair; this design's inner loop is 113 SASS
// instructions for 2 sources x 4 targets, ~14 a pair, one of them a MUFU.
// On an H100 (PERF.md): 0.106 ms at 1000 x 180000 (0.356 before; an IEEE
// root and divide in this layout, 0.249), 43% of the bound; 0.0054 ms at
// a graph_dipole patch of 458 sources (0.051 before).
//
// Design: csrc/field.cu's, from common.cuh (chunked::): a block of 128
// threads holds 4 targets a thread in registers and stages its chunk's
// sources in shared memory, one float4 (x, y, z, px) and one float2 (py,
// pz) a source, read by broadcast. The source axis is cut into chunks
// along grid.y that fill the 132 SMs (chunked::plan): at the lattice's
// 1000 targets, 2 target blocks x 528 chunks of 341 sources at 180000
// sources, 2 x 15 chunks of 31 at a graph_dipole patch of 458. Each block
// writes its chunk's partial sums and potential_finish adds the chunks in
// a fixed order (a target's 32 lanes each sum every 32nd chunk, then one
// thread adds the 32 lane sums): no atomics, the same total on every run.
// A single chunk writes the total itself, in one launch.
//
// Arithmetic: ir = rsqrt.approx.ftz(r2) (one MUFU a pair; relative error
// below 2^-22), phi += ((c ir) ir) ir with explicit multiply-adds
// (-fmad=false stays the build-wide flag): the instructions of c ir^3, but
// finite for every normal r2 with unit moments, where ir^3 overflows below
// r2 = 2e-26 (the plain version's c / r3 stays finite down to r2 ~ 1e-30).
// The sums run in another order than the plain torch version's
// (ops/fields.py, 8192-source tiles): each target is held to it within
// 1e-4 |phi| + 1e-5 max|phi| (tests/test_torch_gpu.py, chip_smoke.py). At
// 1000 x 180000 the worst target is at 0.0026 of that tolerance, with
// approximate or IEEE roots alike (0.0036 before): the sums' order.
//
// A target that lies on a source gets 0/0, which poisons its whole sum,
// and only the total is scrubbed to 0 (JAX fields.py:164,
// fields_pallas.py:197-198): scrubbing a partial would turn a poisoned
// target into a finite one. Here r2 = 0 gives ir = +inf and c = 0, so c ir
// is NaN; a subnormal r2, taken as 0 by .ftz, gives c ir = +-inf or NaN,
// non-finite as the plain version's c / 0 there. potential_finish scrubs
// both totals.

#include "common.cuh"

namespace {

using chunked::kPerThread;
using chunked::kTargets;
using chunked::kThreads;
using chunked::kTile;

constexpr int kFinishLanes = 32;   // lanes that sum a target's chunks

// acc + the potential of source (a.xyz, moment a.w b.x b.y) at target t.
__device__ __forceinline__ float add_pair(float4 a, float2 b, const float* t,
                                          float acc) {
  const float Rx = a.x - t[0];
  const float Ry = a.y - t[1];
  const float Rz = a.z - t[2];
  const float r2 = __fmaf_rn(Rz, Rz, __fmaf_rn(Ry, Ry, Rx * Rx));
  const float c = __fmaf_rn(b.y, Rz, __fmaf_rn(b.x, Ry, a.w * Rx));
  const float ir = rroot(r2);
  return __fmaf_rn(c * ir * ir, ir, acc);
}

// Block (x, y) sums sources [y chunk, (y + 1) chunk) at targets
// [x kTargets, (x + 1) kTargets), thread q-th target x kTargets + q
// kThreads + threadIdx.x. With one chunk it writes the scrubbed potential
// to out, else its partial to partial[y].
__global__ void __launch_bounds__(kThreads)
potential_partial(const float* __restrict__ src, int n_src, int chunk,
                  const float* __restrict__ tgt, int n_tgt,
                  float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float4 sa[kTile];   // x, y, z, px
  __shared__ float2 sb[kTile];   // py, pz
  const int i0 = blockIdx.x * kTargets + threadIdx.x;
  float t[kPerThread][3];
  float acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = i0 + q * kThreads;
#pragma unroll
    for (int c = 0; c < 3; ++c) t[q][c] = i < n_tgt ? tgt[3 * (size_t)i + c] : 0.f;
    acc[q] = 0.f;
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(begin + chunk, n_src);
  for (int base = begin; base < end; base += kTile) {
    const int m = min(kTile, end - base);
    __syncthreads();             // the previous tile is spent
    chunked::stage_sources(src, base, m, sa, sb);
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const float4 a = sa[k];
      const float2 b = sb[k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) acc[q] = add_pair(a, b, t[q], acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = i0 + q * kThreads;
    if (i >= n_tgt) continue;
    if (gridDim.y == 1) {
      out[i] = scrub(acc[q]);
    } else {
      partial[(size_t)blockIdx.y * n_tgt + i] = acc[q];
    }
  }
}

// Thread (x, y) of a block sums chunks y, y + kFinishLanes, ... of target
// blockIdx.x 32 + x in order (a warp reads 32 neighbouring targets of a
// chunk), then lane 0 adds the lane sums in order and scrubs the total.
__global__ void __launch_bounds__(32 * kFinishLanes)
potential_finish(const float* __restrict__ partial, int n_chunks, int n_tgt,
                 float* __restrict__ out) {
  __shared__ float lanes[kFinishLanes][32];
  const int t = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (t < n_tgt) {
#pragma unroll 4
    for (int c = threadIdx.y; c < n_chunks; c += kFinishLanes)
      acc += partial[(size_t)c * n_tgt + t];
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && t < n_tgt) {
    float total = 0.f;
#pragma unroll
    for (int l = 0; l < kFinishLanes; ++l) total += lanes[l][threadIdx.x];
    out[t] = scrub(total);
  }
}

}  // namespace

extern "C" {

// Number of partial sums dipole_potential writes for n_src sources at n_tgt
// targets: the scratch the caller allocates holds that many x n_tgt floats
// (none for a single chunk, which writes out directly).
int dipole_potential_chunks(int n_src, int n_tgt) {
  int n_chunks, chunk;
  chunked::plan(n_src, n_tgt, &n_chunks, &chunk);
  return n_chunks > 1 ? n_chunks : 0;
}

// src (n_src, 6) and tgt (n_tgt, 3), row-major float32 on the device;
// partial (dipole_potential_chunks(n_src, n_tgt), n_tgt) scratch; out
// (n_tgt,). Returns cudaGetLastError().
int dipole_potential(const float* src, int n_src, const float* tgt, int n_tgt,
                     float* partial, float* out, cudaStream_t stream) {
  if (n_tgt <= 0) return 0;
  int n_chunks, chunk;
  chunked::plan(n_src, n_tgt, &n_chunks, &chunk);
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int t_blocks = (n_tgt + kTargets - 1) / kTargets;
  if (n_chunks > 0) {
    potential_partial<<<dim3(t_blocks, n_chunks), kThreads, 0, stream>>>(
        src, n_src, chunk, tgt, n_tgt, partial, out);
  }
  if (n_chunks != 1) {
    potential_finish<<<(n_tgt + 31) / 32, dim3(32, kFinishLanes), 0, stream>>>(
        partial, n_chunks, n_tgt, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
