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

// The terms of the mirror-field ("xie") interaction of source s at target
// t, R = x_s - x_t: nsR = (n_s.R)/r, ntR = (n_t.R)/r, nn = n_s.n_t, r3 =
// r2 r. The XLA tile formula of dipole_tpu/ops/fields.py:305-324 term for
// term (two divides by safe_r, r3 = r2 r) and in the plain torch version's
// order, built with -fmad=false (sqrtf and / IEEE): bit-equal to it.
struct XieTerms {
  float nsR, ntR, nn, r3;
  bool zero;
};

__device__ __forceinline__ XieTerms xie_terms(float sx, float sy, float sz,
                                              float px, float py, float pz,
                                              float tx, float ty, float tz,
                                              float nx, float ny, float nz) {
  const float Rx = sx - tx;
  const float Ry = sy - ty;
  const float Rz = sz - tz;
  const float r2 = Rx * Rx + Ry * Ry + Rz * Rz;
  const bool zero = r2 == 0.f;
  const float r = sqrtf(r2);
  const float safe_r = zero ? 1.f : r;
  XieTerms m;
  m.nsR = (px * Rx + py * Ry + pz * Rz) / safe_r;
  m.ntR = (nx * Rx + ny * Ry + nz * Rz) / safe_r;
  m.nn = px * nx + py * ny + pz * nz;
  m.r3 = r2 * r;
  m.zero = zero;
  return m;
}

// (nn - C first second) / r3 (C first second left to right), nn at r = 0,
// 0 when not finite. With (first, second) = (nsR, ntR) it is the entry of
// s at t, I[t, s]. With (ntR, nsR) it is the mirror entry I[s, t], bit for
// bit: swapping s and t negates R exactly, so r2, r, r3 and nn keep their
// bits, nsR' = -ntR and ntR' = -nsR exactly, and C nsR' ntR' = C ntR nsR.
__device__ __forceinline__ float xie_value(const XieTerms& m, float first,
                                           float second, float C) {
  const float core = m.nn - C * first * second;
  // nn / 1 is nn exactly: one divide on every pair, no branch around it
  const float v = (m.zero ? m.nn : core) / (m.zero ? 1.f : m.r3);
  return isfinite(v) ? v : 0.f;
}

// One entry of the xie interaction matrix, I = the mirror field of source s
// at target t dotted with n_t: (n_s.n_t - C (n_s.R)/r (n_t.R)/r) / r^3, and
// n_s.n_t at r = 0; non-finite entries are 0.
__device__ __forceinline__ float xie_pair(float sx, float sy, float sz,
                                          float px, float py, float pz,
                                          float tx, float ty, float tz,
                                          float nx, float ny, float nz,
                                          float C) {
  const XieTerms m = xie_terms(sx, sy, sz, px, py, pz, tx, ty, tz, nx, ny, nz);
  return xie_value(m, m.nsR, m.ntR, C);
}
