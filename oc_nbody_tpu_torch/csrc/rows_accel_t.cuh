// The first pass of K18 (rows_accel_t.cu), shared with K20 (ring_accel.cu):
// the accel, and with WITH_PHI the potential, of kRows rows against one
// source chunk, summed per lane in the source-split layout of
// rows_split.cuh (COMP: by Kahan steps across stages). A source is staged as
// float4(x, y, z, G m); K20 passes G = 1 and G m itself as the mass, which
// stages the same value (1 * x is exact).

#pragma once

#include "rows_split.cuh"

namespace {

using ocn::split::kLanes;
using ocn::split::kRows;
using ocn::split::kStage;
using ocn::split::kThreads;

template <bool WITH_PHI, bool GUARDED, bool COMP>
__global__ void __launch_bounds__(kThreads)
    rows_accel_t_partial(const float* __restrict__ rows, int nr,
                         const float* __restrict__ src,
                         const float* __restrict__ mass, int ns, int chunk,
                         float G, float eps2, float* __restrict__ part) {
  constexpr int kComp = WITH_PHI ? 4 : 3;
  __shared__ float4 tile[kStage];
  __shared__ float red[kLanes][kComp][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) {
    xi = rows[3 * i];
    yi = rows[3 * i + 1];
    zi = rows[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  float cx = 0.f, cy = 0.f, cz = 0.f, cp = 0.f;  // the Kahan compensations
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1)
      tile[threadIdx.x] =
          make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], G * mass[j]);
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    // K18 sums into (ax, ay, az, ph) directly; K18<COMP> into a fresh
    // stage partial
    float px = 0.f, py = 0.f, pz = 0.f, pp = 0.f;
    float& sx = COMP ? px : ax;
    float& sy = COMP ? py : ay;
    float& sz = COMP ? pz : az;
    float& sp = COMP ? pp : ph;
    if (m == kStage) {
#pragma unroll 8
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_pair<WITH_PHI, GUARDED>(tile[k], xi, yi, zi, eps2, sx, sy,
                                         sz, sp);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_pair<WITH_PHI, GUARDED>(tile[k], xi, yi, zi, eps2, sx, sy,
                                         sz, sp);
    }
    if (COMP) {
      ocn::kahan_add(ax, cx, px);
      ocn::kahan_add(ay, cy, py);
      ocn::kahan_add(az, cz, pz);
      if (WITH_PHI) ocn::kahan_add(ph, cp, pp);
    }
    __syncthreads();
  }
  const float v[4] = {ax, ay, az, ph};
  ocn::split::store_partials<kComp>(red, v, lane, r, live, c, nr, i, part);
}

}  // namespace
