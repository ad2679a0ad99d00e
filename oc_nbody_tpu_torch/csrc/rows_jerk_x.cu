// K9: one-sided softened accel + jerk of a row set from a source set at
// the extended (hi/lo) precision tier: the block-timestep active-row
// evaluation of that tier (a handful to a few thousand rows against all
// sources) and the Hermite self-interaction below the pair-symmetric
// kernel's floor.
//
// Replaces the TPU row sweep _accel_jerk_kernel_x
// (oc_nbody_tpu/ops/pallas_gravity.py:1208, launched by
// accel_jerk_rows_x_hilo at :1590).
//
// K17, its compensated variant (COMP), replaces the TPU streamed kernel
// _accel_jerk_stream_kernel_x (pallas_gravity.py:1415), which
// accel_jerk_rows_x_hilo takes past STREAM_N = 262,144 sources or
// RT_MAX_ROWS = 65,536 rows (:1596): the block stepper's active rows at the
// extended tier when N > 262,144, or when more than 65,536 rows are active
// (every particle, at each multiple of dt_max). That kernel streams the
// sources in tiles of TJ_XS = 1,024 and adds each tile's partial to the
// running sum with a Kahan step (_two_sum, :1444-1451). Here, as in K14
// (rows_jerk_t.cu), each lane sums a stage's 32 sources into a fresh
// partial and adds it to its running sum by a Kahan step, and pass 2 adds
// the chunk partials by Kahan steps, in the JAX package's form
// (pair.cuh:kahan_add, spelled with __fadd_rn / __fsub_rn so that --fmad
// cannot contract it). It adds 24 flops per lane and stage of 32 pairs.
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 positions and
// velocities that the caller centred once, on the sources' centre for both
// sets, and split in f64; gm is (G m in f64) rounded to f32. The pair
// arithmetic is pair.cuh:row_jerk_pair_x.
//
// Bound on the card: 65 f32 flops (an FMA counts 2) and one rsqrtf per
// pair; each source (52 bytes) is read once per block from device memory
// (or L2) for 32 rows, and the partial sums are 24 bytes per row and chunk,
// so bytes never bind: the FMA pipe does.
//
// Design: K5's, the source-split layout of rows_split.cuh (two passes, no
// atomics, fixed summation order), because under block steps the rows are
// few and a one-thread-per-row layout would fill a fraction of the card.
// Pass 1 stages the chunk as four float4 (hi with G m,
// lo, velocity hi, velocity lo); each thread sums its sources into its six
// sums (K17: into a stage partial, then Kahan into its sums); pass 2 adds
// the chunk partials (K17: by Kahan steps). A row's result does not depend
// on the launch's other rows, so a compacted active set and the masked full
// set agree. At 1M sources there are 128 chunks of 8,192 and the scratch is
// 6 x 128 x nr floats, 3.2 GB at nr = 1,048,576.
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

template <bool GUARDED, bool COMP>
__global__ void __launch_bounds__(kThreads)
    rows_jerk_x_partial(const float* __restrict__ rhi,
                        const float* __restrict__ rlo,
                        const float* __restrict__ vhi,
                        const float* __restrict__ vlo, int nr,
                        const float* __restrict__ shi,
                        const float* __restrict__ slo,
                        const float* __restrict__ svhi,
                        const float* __restrict__ svlo,
                        const float* __restrict__ gm, int ns, int chunk,
                        float eps2, float* __restrict__ part) {
  __shared__ float4 thi[kStage];
  __shared__ float4 tlo[kStage];
  __shared__ float4 tvh[kStage];
  __shared__ float4 tvl[kStage];
  __shared__ float red[kLanes][6][kRows];
  const int r = threadIdx.x % kRows;
  const int lane = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 xi = zero, li = zero, vi = zero, vli = zero;
  if (live) {
    xi = row3(rhi, i);
    li = row3(rlo, i);
    vi = row3(vhi, i);
    vli = row3(vlo, i);
  }
  float3 a = zero, jk = zero;
  float3 ca = zero, cj = zero;  // K17's Kahan compensations
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      thi[threadIdx.x] = src4(shi, j, gm[j]);
      tlo[threadIdx.x] = src4(slo, j, 0.f);
      tvh[threadIdx.x] = src4(svhi, j, 0.f);
      tvl[threadIdx.x] = src4(svlo, j, 0.f);
    }
    __syncthreads();
    const int m = min(kStage, c1 - s0);
    // K9 sums into (a, jk) directly; K17 into a fresh stage partial
    float3 pa = zero, pj = zero;
    float3& sa = COMP ? pa : a;
    float3& sj = COMP ? pj : jk;
    if (m == kStage) {
#pragma unroll 4
      for (int k = lane; k < kStage; k += kLanes)
        ocn::row_jerk_pair_x<GUARDED>(thi[k], tlo[k], tvh[k], tvl[k], xi, li,
                                      vi, vli, eps2, sa, sj);
    } else {
      for (int k = lane; k < m; k += kLanes)
        ocn::row_jerk_pair_x<GUARDED>(thi[k], tlo[k], tvh[k], tvl[k], xi, li,
                                      vi, vli, eps2, sa, sj);
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

template <bool GUARDED, bool COMP>
void launch(const float* rhi, const float* rlo, const float* vhi,
            const float* vlo, int nr, const float* shi, const float* slo,
            const float* svhi, const float* svlo, const float* gm, int ns,
            float eps2, float* part, float* acc, float* jerk,
            cudaStream_t s) {
  rows_jerk_x_partial<GUARDED, COMP>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm, ns,
          ocn::split::chunk_size(ns), eps2, part);
  ocn::split::launch_reduce<6, COMP, false>(part, nr, ns, acc, jerk, s);
}

}  // namespace

// Floats of scratch the launch needs: six per row and source chunk.
extern "C" long long ocn_rows_jerk_x_scratch(int nr, int ns) {
  return ocn::split::scratch_floats(nr, ns, 6);
}

// rhi, rlo, vhi, vlo (nr, 3), shi, slo, svhi, svlo (ns, 3), gm (ns,), acc
// and jerk (nr, 3) are contiguous f32 on the device; part holds
// ocn_rows_jerk_x_scratch(nr, ns) floats. compensated picks K17 (Kahan
// steps across stages and chunks) over K9. Returns cudaGetLastError() after
// the launches.
extern "C" int ocn_rows_jerk_x(const float* rhi, const float* rlo,
                               const float* vhi, const float* vlo, int nr,
                               const float* shi, const float* slo,
                               const float* svhi, const float* svlo,
                               const float* gm, int ns, float eps2,
                               int guarded, int compensated, float* part,
                               float* acc, float* jerk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(jerk, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (compensated) {
    if (guarded)
      launch<true, true>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm, ns,
                         eps2, part, acc, jerk, s);
    else
      launch<false, true>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                          ns, eps2, part, acc, jerk, s);
  } else {
    if (guarded)
      launch<true, false>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                          ns, eps2, part, acc, jerk, s);
    else
      launch<false, false>(rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gm,
                           ns, eps2, part, acc, jerk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
