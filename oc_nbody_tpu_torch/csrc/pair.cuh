// Pair physics shared by the gravity kernels: softened f32 accel, potential
// and jerk of one source on one row, on centred coordinates, and the tile
// layout of the pair-symmetric kernels.
//
// Conventions (oc_nbody_tpu/ops/gravity.py): d = x_j - x_i points at the
// source, dv = v_j - v_i, u = |d|^2 + eps^2, inv = u^-1/2,
//   a_i   += G m_j d inv^3
//   phi_i -= G m_j inv      (the self term is removed by the caller)
//   j_i   += G m_j inv^3 (dv - 3 (d.dv) inv^2 d)
// A source is a float4 (x, y, z, G m), its velocity a float4 (vx, vy, vz, 0).
// No fast-math: rsqrtf keeps its documented 2-ulp bound; FMA contraction is
// allowed.
#pragma once

#include <cuda_runtime.h>

namespace ocn {

// Tile edge of the pair-symmetric kernels (K2, K3): one block of kSymTile
// threads per tile pair.
constexpr int kSymTile = 128;

// Zero-guarded rsqrt (ops/pallas_pair.py:_inv_r). GUARDED is for eps == 0,
// where a self pair has u == 0 and must add nothing. With eps > 0,
// u >= eps^2 > 0 everywhere and the compare is dropped.
template <bool GUARDED>
__device__ __forceinline__ float inv_r(float u) {
  if (GUARDED) return u > 0.f ? rsqrtf(u) : 0.f;
  return rsqrtf(u);
}

// One-sided pair: the action of source s on the row at (xi, yi, zi).
// ph accumulates +G m_j inv; the caller stores -ph.
template <bool WITH_PHI, bool GUARDED>
__device__ __forceinline__ void row_pair(float4 s, float xi, float yi,
                                         float zi, float eps2, float& ax,
                                         float& ay, float& az, float& ph) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = inv_r<GUARDED>(u);
  const float gminv = s.w * inv;
  const float w = gminv * (inv * inv);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
  if (WITH_PHI) ph += gminv;
}

// One-sided accel+jerk pair (pallas_gravity.py:_accel_jerk_kernel): the
// action of source s moving at sv on the row at xi moving at vi. With
// GUARDED and u == 0, inv = 0 gives w = 0 and s = 0: a self pair adds
// nothing to either sum.
template <bool GUARDED>
__device__ __forceinline__ void row_jerk_pair(float4 s, float4 sv, float3 xi,
                                              float3 vi, float eps2,
                                              float3& a, float3& j) {
  const float dx = s.x - xi.x, dy = s.y - xi.y, dz = s.z - xi.z;
  const float dvx = sv.x - vi.x, dvy = sv.y - vi.y, dvz = sv.z - vi.z;
  const float u = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = inv_r<GUARDED>(u);
  const float inv2 = inv * inv;
  const float w = s.w * (inv * inv2);
  const float rv = dx * dvx + dy * dvy + dz * dvz;
  const float sc = (3.f * rv) * w * inv2;
  a.x += w * dx;
  a.y += w * dy;
  a.z += w * dz;
  j.x += w * dvx - sc * dx;
  j.y += w * dvy - sc * dy;
  j.z += w * dvz - sc * dz;
}

// First linear block index of row I of the upper triangle of tile pairs,
// whose rows hold J = I .. nt-1.
__device__ __forceinline__ long long triangle_start(long long I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

// Linear block index b -> tile pair (I, J) with I <= J.
__device__ __forceinline__ void tile_pair(long long b, int nt, int& I,
                                          int& J) {
  const double a = 2.0 * nt + 1.0;
  int i = static_cast<int>(0.5 * (a - sqrt(a * a - 8.0 * static_cast<double>(b))));
  i = max(0, min(i, nt - 1));
  while (i > 0 && triangle_start(i, nt) > b) --i;
  while (i + 1 < nt && triangle_start(i + 1, nt) <= b) ++i;
  I = i;
  J = i + static_cast<int>(b - triangle_start(i, nt));
}

}  // namespace ocn
