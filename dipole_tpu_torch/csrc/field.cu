// Dipole field at target points, eps 1e-5 by default:
//   E_t = -sum_s [3 (p_s . R) R / (r^2 (r^3 + eps)) - p_s / (r^3 + eps)],
// R = x_s - x_t; coincident pairs contribute nothing; a non-finite total
// component is 0.
//
// Replaces: dipole_tpu/ops/fields_pallas.py:_field_kernel + _pair_terms
// (via field_grad_pallas), reached from fields.field_grad: the rest-point
// pass of orient_large (dipole_tpu/ops/propagate.py:479-498) and
// reference_field (orientation transfer, fields.py:262-280).
//
// What bounds it on an H100: operations. T targets x S sources pairs of
// ~30 flops (a sqrt and a divide each) against 24 bytes per source and 24
// per target: at 180k x 10k, 5.4e10 flops (0.8 ms at 67 TFLOP/s fp32).
//
// Design: one thread per target, sources staged in shared memory kTile at
// a time in a fixed order, as in potential.cu. The source axis is split
// into chunks of kChunk along grid.y so that a few thousand targets still
// fill the 132 SMs; each block writes its chunk's partial field and a
// second kernel adds the chunks in order, then scrubs: no atomics, the
// same total on every run. A partial is -(term_R - term_p) of its chunk,
// the structure of the XLA scan (one such tile sum per source block,
// fields.py:107-121, 136-149), and only the final total is scrubbed.
//
// Arithmetic: the XLA tile formula of dipole_tpu/ops/fields.py:107-121 with
// one reciprocal per pair (t = 1/(safe_r2 denom), a = 3 c t, b = safe_r2 t),
// term_R and term_p summed separately; -fmad=false, sqrtf and / IEEE. The
// sums run in another order than the plain torch version's: rtol 1e-4.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // targets per block
constexpr int kTile = 128;     // sources staged in shared memory at a time
constexpr int kChunk = 2048;   // sources per block along grid.y

__global__ void __launch_bounds__(kThreads)
field_partial(const float* __restrict__ src, int n_src,
              const float* __restrict__ tgt, int n_tgt, float eps,
              float* __restrict__ partial) {
  __shared__ float s[6][kTile];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < n_tgt;
  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (live) {
    tx = tgt[3 * (size_t)t];
    ty = tgt[3 * (size_t)t + 1];
    tz = tgt[3 * (size_t)t + 2];
  }
  const int begin = blockIdx.y * kChunk;
  const int end = min(begin + kChunk, n_src);
  float rx = 0.f, ry = 0.f, rz = 0.f;  // term_R
  float qx = 0.f, qy = 0.f, qz = 0.f;  // term_p
  for (int base = begin; base < end; base += kTile) {
    const int j = base + threadIdx.x;
    if (j < end) {
#pragma unroll
      for (int c = 0; c < 6; ++c) s[c][threadIdx.x] = src[6 * (size_t)j + c];
    }
    __syncthreads();
    const int m = min(kTile, end - base);
    for (int k = 0; k < m; ++k) {
      const float px = s[3][k], py = s[4][k], pz = s[5][k];
      const float Rx = s[0][k] - tx;
      const float Ry = s[1][k] - ty;
      const float Rz = s[2][k] - tz;
      const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
      const bool zero = r2 == 0.f;
      const float r = sqrtf(r2);
      const float denom = r * r2 + eps;
      const float c = px * Rx + py * Ry + pz * Rz;
      const float safe_r2 = zero ? 1.f : r2;
      const float inv = 1.f / (safe_r2 * denom);
      const float a = zero ? 0.f : 3.f * c * inv;
      const float b = zero ? 0.f : safe_r2 * inv;
      rx += a * Rx;
      ry += a * Ry;
      rz += a * Rz;
      qx += b * px;
      qy += b * py;
      qz += b * pz;
    }
    __syncthreads();
  }
  if (live) {
    float* out = partial + ((size_t)blockIdx.y * n_tgt + t) * 3;
    out[0] = -(rx - qx);
    out[1] = -(ry - qy);
    out[2] = -(rz - qz);
  }
}

__global__ void field_finish(const float* __restrict__ partial, int n_chunks,
                             int n_tgt, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tgt) return;
  float e[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = partial + ((size_t)c * n_tgt + t) * 3;
    e[0] += p[0];
    e[1] += p[1];
    e[2] += p[2];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * (size_t)t + k] = isfinite(e[k]) ? e[k] : 0.f;
}

}  // namespace

extern "C" {

// Number of source chunks for n_src sources: the partial buffer the caller
// allocates holds chunks x n_tgt x 3 floats.
int dipole_field_chunks(int n_src) { return (n_src + kChunk - 1) / kChunk; }

// src (n_src, 6) and tgt (n_tgt, 3), row-major float32 on the device;
// partial (chunks, n_tgt, 3) scratch; out (n_tgt, 3). Returns
// cudaGetLastError().
int dipole_field(const float* src, int n_src, const float* tgt, int n_tgt,
                 float eps, float* partial, float* out, cudaStream_t stream) {
  if (n_tgt <= 0) return 0;
  const int n_chunks = dipole_field_chunks(n_src);
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int t_blocks = (n_tgt + kThreads - 1) / kThreads;
  if (n_chunks > 0) {
    field_partial<<<dim3(t_blocks, n_chunks), kThreads, 0, stream>>>(
        src, n_src, tgt, n_tgt, eps, partial);
  }
  field_finish<<<t_blocks, kThreads, 0, stream>>>(partial, n_chunks, n_tgt,
                                                  out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
