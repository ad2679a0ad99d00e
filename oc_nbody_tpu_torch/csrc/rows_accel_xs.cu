// K19: one-sided softened accel, and optionally the raw pair potential, of
// rows from sources at the extended (hi/lo) precision tier, with Kahan steps
// across source stages and chunks: the rows accel forms of that tier past
// STREAM_N = 262,144 sources or RT_MAX_ROWS = 65,536 rows. Escape pruning
// reaches it from both sides: every particle against the cluster bucket
// (sweep 1, 1,048,576 rows against B sources in c10p) and the bucket
// against every particle (sweep 2, B rows against 1,048,576 sources).
//
// Replaces the TPU streamed kernels _accel_stream_kernel_x and
// _accel_phi_stream_kernel_x (oc_nbody_tpu/ops/pallas_gravity.py:1361,
// :1384), which accel_rows_x_hilo and accel_potential_rows_x_hilo take past
// STREAM_N sources or RT_MAX_ROWS rows (:1461, :1524). Those stream the
// sources in tiles of TJ_XS = 1,024 and add each tile's partial to the
// running sums by a Kahan step, on the accel and on the potential. Here, as
// in K17 (rows_jerk_x.cu), each lane sums a stage's 32 sources into a fresh
// partial and adds it to its running sums by a Kahan step, and pass 2 adds
// the chunk partials by Kahan steps (pair.cuh:kahan_add, spelled with
// __fadd_rn / __fsub_rn so that --fmad cannot contract it).
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 positions that the
// caller centred once, in one frame for both sets, and split in f64; gm is
// (G m in f64) rounded to f32. The pair arithmetic is pair.cuh:row_pair_x,
// the one K8 runs: 36 f32 flops per pair (37 with the potential; an FMA
// counts 2) and one rsqrtf. The potential is RAW: it keeps the softened
// self term -G m/eps of a row that is also a source; the caller adds
// self_phi.
//
// Design: the source-split layout of rows_split.cuh, which K17 shares.
// Pass 1 stages the chunk as two float4 (hi with G m, lo); each thread sums
// a stage's sources into a stage partial and adds it to its sums by a Kahan
// step; pass 2 adds the chunk partials by Kahan steps and stores the
// potential negated. The layout serves both shapes of the pruned sweeps:
// few rows against many sources fill the card through the source chunks,
// many rows against few sources through the row tiles. At 1,048,576 rows
// against 131,072 sources there are 128 chunks of 1,024 and the scratch is
// 4 x 128 x nr floats, 2.1 GB.
//
// The ragged last stage is masked by the loop bound; rows past nr compute
// and store nothing, so no input is padded.

#include "rows_split.cuh"

namespace {

using ocn::split::kLanes;
using ocn::split::kRows;
using ocn::split::kStage;
using ocn::split::kThreads;

__device__ __forceinline__ float3 row3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float4 src4(const float* __restrict__ p, int j,
                                       float w) {
  return make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], w);
}

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    rows_accel_xs_partial(const float* __restrict__ rhi,
                          const float* __restrict__ rlo, int nr,
                          const float* __restrict__ shi,
                          const float* __restrict__ slo,
                          const float* __restrict__ gm, int ns, int chunk,
                          float eps2, float* __restrict__ part) {
  constexpr int kComp = WITH_PHI ? 4 : 3;
  __shared__ float4 thi[kStage];
  __shared__ float4 tlo[kStage];
  __shared__ float red[kLanes][kComp][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 xi = zero, li = zero;
  if (live) {
    xi = row3(rhi, i);
    li = row3(rlo, i);
  }
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  float cx = 0.f, cy = 0.f, cz = 0.f, cp = 0.f;  // the Kahan compensations
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      thi[threadIdx.x] = src4(shi, j, gm[j]);
      tlo[threadIdx.x] = src4(slo, j, 0.f);
    }
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    float px = 0.f, py = 0.f, pz = 0.f, pp = 0.f;
    if (m == kStage) {
#pragma unroll 4
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_pair_x<WITH_PHI, GUARDED>(thi[k], tlo[k], xi, li, eps2, px,
                                           py, pz, pp);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_pair_x<WITH_PHI, GUARDED>(thi[k], tlo[k], xi, li, eps2, px,
                                           py, pz, pp);
    }
    ocn::kahan_add(ax, cx, px);
    ocn::kahan_add(ay, cy, py);
    ocn::kahan_add(az, cz, pz);
    if (WITH_PHI) ocn::kahan_add(ph, cp, pp);
    __syncthreads();
  }
  const float v[4] = {ax, ay, az, ph};
  ocn::split::store_partials<kComp>(red, v, lane, r, live, c, nr, i, part);
}

template <bool WITH_PHI, bool GUARDED>
void launch(const float* rhi, const float* rlo, int nr, const float* shi,
            const float* slo, const float* gm, int ns, float eps2,
            float* part, float* acc, float* phi, cudaStream_t s) {
  rows_accel_xs_partial<WITH_PHI, GUARDED>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rhi, rlo, nr, shi, slo, gm, ns, ocn::split::chunk_size(ns), eps2,
          part);
  ocn::split::launch_reduce<WITH_PHI ? 4 : 3, true, true>(part, nr, ns, acc,
                                                          phi, s);
}

}  // namespace

// Floats of scratch the launch needs: three per row and source chunk, four
// with the potential.
extern "C" long long ocn_rows_accel_xs_scratch(int nr, int ns, int with_phi) {
  return ocn::split::scratch_floats(nr, ns, with_phi ? 4 : 3);
}

// rhi, rlo (nr, 3), shi, slo (ns, 3), gm (ns,) and acc (nr, 3) are
// contiguous f32 on the device; phi (nr,) may be null, and then no
// potential is computed; part holds ocn_rows_accel_xs_scratch(nr, ns, phi !=
// null) floats. Returns cudaGetLastError() after the launches.
extern "C" int ocn_rows_accel_xs(const float* rhi, const float* rlo, int nr,
                                 const float* shi, const float* slo,
                                 const float* gm, int ns, float eps2,
                                 int guarded, float* part, float* acc,
                                 float* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
    if (phi != nullptr) cudaMemsetAsync(phi, 0, sizeof(float) * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (phi != nullptr) {
    if (guarded)
      launch<true, true>(rhi, rlo, nr, shi, slo, gm, ns, eps2, part, acc, phi,
                         s);
    else
      launch<true, false>(rhi, rlo, nr, shi, slo, gm, ns, eps2, part, acc,
                          phi, s);
  } else {
    if (guarded)
      launch<false, true>(rhi, rlo, nr, shi, slo, gm, ns, eps2, part, acc,
                          phi, s);
    else
      launch<false, false>(rhi, rlo, nr, shi, slo, gm, ns, eps2, part, acc,
                           phi, s);
  }
  return static_cast<int>(cudaGetLastError());
}
