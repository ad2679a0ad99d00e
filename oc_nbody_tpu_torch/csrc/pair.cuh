// Pair physics shared by the gravity kernels: softened f32 accel and
// potential of one source on one row, on centred coordinates.
//
// Conventions (oc_nbody_tpu/ops/gravity.py): d = x_j - x_i points at the
// source, u = |d|^2 + eps^2, inv = u^-1/2,
//   a_i   += G m_j d inv^3
//   phi_i -= G m_j inv      (the self term is removed by the caller)
// A source is a float4 (x, y, z, G m). No fast-math: rsqrtf keeps its
// documented 2-ulp bound; FMA contraction is allowed.
#pragma once

#include <cuda_runtime.h>

namespace ocn {

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

}  // namespace ocn
