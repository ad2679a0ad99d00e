// The first pass of K5 and K14 (rows_jerk_t.cu), shared with K21
// (ring_jerk.cu): the accel + jerk of kRows rows against one source chunk,
// summed per lane in the source-split layout of rows_split.cuh (COMP: by
// Kahan steps across stages). A source is staged as float4(x, y, z, G m)
// and float4(vx, vy, vz, 0); K21 passes G = 1 and G m itself as the mass,
// which stages the same value (1 * x is exact).

#pragma once

#include "rows_split.cuh"

namespace {

using ocn::split::kLanes;
using ocn::split::kRows;
using ocn::split::kStage;
using ocn::split::kThreads;

template <bool GUARDED, bool COMP>
__global__ void __launch_bounds__(kThreads)
    rows_jerk_t_partial(const float* __restrict__ rows,
                        const float* __restrict__ vrows, int nr,
                        const float* __restrict__ src,
                        const float* __restrict__ svel,
                        const float* __restrict__ mass, int ns, int chunk,
                        float G, float eps2, float* __restrict__ part) {
  __shared__ float4 tile[kStage];
  __shared__ float4 vtile[kStage];
  __shared__ float red[kLanes][6][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  float3 xi = make_float3(0.f, 0.f, 0.f), vi = make_float3(0.f, 0.f, 0.f);
  if (live) {
    xi = make_float3(rows[3 * i], rows[3 * i + 1], rows[3 * i + 2]);
    vi = make_float3(vrows[3 * i], vrows[3 * i + 1], vrows[3 * i + 2]);
  }
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 a = zero, jk = zero;
  float3 ca = zero, cj = zero;  // K14's Kahan compensations
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      tile[threadIdx.x] =
          make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], G * mass[j]);
      vtile[threadIdx.x] =
          make_float4(svel[3 * j], svel[3 * j + 1], svel[3 * j + 2], 0.f);
    }
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    // K5 sums into (a, jk) directly; K14 into a fresh stage partial
    float3 pa = zero, pj = zero;
    float3& sa = COMP ? pa : a;
    float3& sj = COMP ? pj : jk;
    if (m == kStage) {
#pragma unroll 8
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, sa, sj);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, sa, sj);
    }
    if (COMP) {
      ocn::kahan_add3(a, ca, pa);
      ocn::kahan_add3(jk, cj, pj);
    }
    __syncthreads();
  }
  const float v[6] = {a.x, a.y, a.z, jk.x, jk.y, jk.z};
  ocn::split::store_partials<6>(red, v, lane, r, live, c, nr, i, part);
}

}  // namespace
