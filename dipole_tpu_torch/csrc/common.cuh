// Shared by every kernel library of the port: each library is built on its
// own (one nvcc per source) and exports the error-string lookup its ctypes
// wrapper uses to report a failed launch.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

extern "C" const char* dipole_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One entry of the interaction matrix, I = E_s(x_t) . n_t with R = x_s - x_t:
// the two-divide XLA formula of dipole_tpu/ops/fields.py:287-302
// (-(3c.Rn/(safe_r2.denom) - pn/denom), denom = r.r2 + eps), term for term
// and in the order of the plain torch version (fields.py of the port).
// Built with -fmad=false (sqrtf and / IEEE), so a kernel that calls it
// agrees with the plain version bit for bit. Coincident pairs and
// non-finite entries are 0.
__device__ __forceinline__ float dipole_pair(float sx, float sy, float sz,
                                             float px, float py, float pz,
                                             float tx, float ty, float tz,
                                             float nx, float ny, float nz,
                                             float eps) {
  const float Rx = sx - tx;
  const float Ry = sy - ty;
  const float Rz = sz - tz;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float rr = sqrtf(r2);
  const float denom = rr * r2 + eps;
  const float c = px * Rx + py * Ry + pz * Rz;
  const float Rn = nx * Rx + ny * Ry + nz * Rz;
  const float pn = px * nx + py * ny + pz * nz;
  const float safe_r2 = zero ? 1.f : r2;
  const float v = -(3.f * c * Rn / (safe_r2 * denom) - pn / denom);
  return (zero || !isfinite(v)) ? 0.f : v;
}

// One entry of the mirror-field ("xie") interaction matrix, I = the xie
// field of source s at target t dotted with n_t, R = x_s - x_t:
// (n_s.n_t - C (n_s.R)/r (n_t.R)/r) / r^3, and n_s.n_t at r = 0. The XLA
// tile formula of dipole_tpu/ops/fields.py:305-324 term for term (two
// divides by safe_r, core / r3 with r3 = r2 r, C nsR ntR left to right) and
// in the plain torch version's order, built with -fmad=false: bit-equal to
// it. Non-finite entries are 0.
__device__ __forceinline__ float xie_pair(float sx, float sy, float sz,
                                          float px, float py, float pz,
                                          float tx, float ty, float tz,
                                          float nx, float ny, float nz,
                                          float C) {
  const float Rx = sx - tx;
  const float Ry = sy - ty;
  const float Rz = sz - tz;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float r = sqrtf(r2);
  const float safe_r = zero ? 1.f : r;
  const float nsR = (px * Rx + py * Ry + pz * Rz) / safe_r;
  const float ntR = (nx * Rx + ny * Ry + nz * Rz) / safe_r;
  const float nn = px * nx + py * ny + pz * nz;
  const float core = nn - C * nsR * ntR;
  const float r3 = r2 * r;
  const float v = zero ? nn : core / r3;
  return isfinite(v) ? v : 0.f;
}
