// K11: softened self-interaction accel + jerk at the two-float (df32) tier,
// the Hermite force evaluation of that tier: every pair quantity and both
// sums over sources a (hi, lo) pair of f32.
//
// Replaces the TPU kernel _accel_jerk_kernel_df
// (oc_nbody_tpu/ops/pallas_df.py:186, launched by accel_jerk_df_pallas at
// :264). The scale of the jerk's radial term is 3 (d.dv) taken by df_mul_f,
// as the jnp reference of the tier takes it (oc_nbody_tpu/ops/df32.py:521).
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 positions and
// velocities, each centred once and split in f64; gm = G m and eps^2 are
// formed in f64 and split too. The pair arithmetic is df.cuh:df_jerk_pair;
// the outputs are the hi and lo planes of the acceleration and the jerk,
// summed in f64 by the caller.
//
// Bound on the card: 481 f32 flops (an FMA counts 2) and one rsqrtf per
// pair; a source is 64 bytes read once per block for 32 rows, so bytes
// never bind: the f32 pipe does.
//
// Design (df.cuh, "launch plan"): K10's, with six df accumulators per
// thread and four float4 per staged source. Fixed summation order, no
// atomics: two launches agree bitwise.

#include "df.cuh"

namespace {

using namespace ocn;

template <bool GUARDED>
__global__ void __launch_bounds__(kDfThreads)
    rows_jerk_df_partial(const float* __restrict__ rhi,
                         const float* __restrict__ rlo,
                         const float* __restrict__ vhi,
                         const float* __restrict__ vlo, int nr,
                         const float* __restrict__ shi,
                         const float* __restrict__ slo,
                         const float* __restrict__ svhi,
                         const float* __restrict__ svlo,
                         const float* __restrict__ gmhi,
                         const float* __restrict__ gmlo, int ns, int chunk,
                         float e2hi, float e2lo, float* __restrict__ part) {
  __shared__ float4 thi[kDfStage];
  __shared__ float4 tlo[kDfStage];
  __shared__ float4 tvh[kDfStage];
  __shared__ float4 tvl[kDfStage];
  __shared__ float red[kDfLanes][12][kDfRows];
  const int r = threadIdx.x % kDfRows;
  const int lane = threadIdx.x / kDfRows;
  const int i = blockIdx.x * kDfRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  const float3 xh = live ? df_row3(rhi, i) : zero;
  const float3 xl = live ? df_row3(rlo, i) : zero;
  const float3 uh = live ? df_row3(vhi, i) : zero;
  const float3 ul = live ? df_row3(vlo, i) : zero;
  const df eps2 = {e2hi, e2lo};
  const df z = {0.f, 0.f};
  df3 a = {z, z, z}, jk = {z, z, z};
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kDfStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      thi[threadIdx.x] = df_src4(shi, j, gmhi[j]);
      tlo[threadIdx.x] = df_src4(slo, j, gmlo[j]);
      tvh[threadIdx.x] = df_src4(svhi, j, 0.f);
      tvl[threadIdx.x] = df_src4(svlo, j, 0.f);
    }
    __syncthreads();
    const int m = min(kDfStage, c1 - s0);
    for (int k = lane; k < m; k += kDfLanes)
      df_jerk_pair<GUARDED>(thi[k], tlo[k], tvh[k], tvl[k], xh, xl, uh, ul,
                            eps2, a, jk);
    __syncthreads();
  }
  red[lane][0][r] = a.x.hi;
  red[lane][1][r] = a.y.hi;
  red[lane][2][r] = a.z.hi;
  red[lane][3][r] = jk.x.hi;
  red[lane][4][r] = jk.y.hi;
  red[lane][5][r] = jk.z.hi;
  red[lane][6][r] = a.x.lo;
  red[lane][7][r] = a.y.lo;
  red[lane][8][r] = a.z.lo;
  red[lane][9][r] = jk.x.lo;
  red[lane][10][r] = jk.y.lo;
  red[lane][11][r] = jk.z.lo;
  __syncthreads();
  if (live) df_reduce_lanes<6>(red, lane, r, c, i, nr, part);
}

}  // namespace

// Floats of scratch the launch needs: twelve per row and source chunk.
extern "C" long long ocn_rows_jerk_df_scratch(int nr, int ns) {
  if (nr <= 0 || ns <= 0) return 0;
  int chunk, nchunks;
  ocn::df_plan(nr, ns, chunk, nchunks);
  return 12LL * nchunks * nr;
}

// rhi, rlo, vhi, vlo (nr, 3), shi, slo, svhi, svlo (ns, 3), gmhi, gmlo
// (ns,), ahi, alo, jhi and jlo (nr, 3) are contiguous f32 on the device;
// part holds ocn_rows_jerk_df_scratch(nr, ns) floats. Returns
// cudaGetLastError() after the launches.
extern "C" int ocn_rows_jerk_df(const float* rhi, const float* rlo,
                                const float* vhi, const float* vlo, int nr,
                                const float* shi, const float* slo,
                                const float* svhi, const float* svlo,
                                const float* gmhi, const float* gmlo, int ns,
                                float e2hi, float e2lo, int guarded,
                                float* part, float* ahi, float* alo,
                                float* jhi, float* jlo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(ahi, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(alo, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(jhi, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(jlo, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  int chunk, nchunks;
  ocn::df_plan(nr, ns, chunk, nchunks);
  const dim3 grid((nr + kDfRows - 1) / kDfRows, nchunks);
  if (guarded)
    rows_jerk_df_partial<true><<<grid, kDfThreads, 0, s>>>(
        rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gmhi, gmlo, ns, chunk,
        e2hi, e2lo, part);
  else
    rows_jerk_df_partial<false><<<grid, kDfThreads, 0, s>>>(
        rhi, rlo, vhi, vlo, nr, shi, slo, svhi, svlo, gmhi, gmlo, ns, chunk,
        e2hi, e2lo, part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return ocn::df_launch_reduce<6>(part, nr, nchunks, ahi, alo, jhi, jlo, s);
}
