// K10: softened self-interaction accel at the two-float (df32) tier: every
// pair quantity and the sum over sources a (hi, lo) pair of f32, about 48
// significand bits, so the result is f64-class on f32 pipes.
//
// Replaces the TPU kernel _accel_kernel_df
// (oc_nbody_tpu/ops/pallas_df.py:121, launched by accel_df_pallas at :316).
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 positions centred
// once and split in f64; gm = G m and eps^2 are formed in f64 and split
// too. The pair arithmetic is df.cuh:df_accel_pair; the outputs are the hi
// and lo planes of the acceleration, summed in f64 by the caller.
//
// Bound on the card: 233 f32 flops (an FMA counts 2) and one rsqrtf per
// pair; a source is 32 bytes read once per block for 32 rows, so bytes
// never bind: the f32 pipe does. Nearly every operation of an error-free
// transform is a lone add or multiply, so the pipe retires one flop where
// the bound counts two.
//
// Design (df.cuh, "launch plan"): sources split into chunks, a block of 32
// rows x 8 source lanes per row tile and chunk, three df accumulators per
// thread in registers, the lanes' and then the chunks' sums added by df_add
// in a fixed order. No atomics, no f32 sum of a hi plane: two launches
// agree bitwise. The ragged last stage is masked by the loop bound; rows
// past nr compute and store nothing, so no input is padded.

#include "df.cuh"

namespace {

using namespace ocn;

template <bool GUARDED>
__global__ void __launch_bounds__(kDfThreads)
    rows_accel_df_partial(const float* __restrict__ rhi,
                          const float* __restrict__ rlo, int nr,
                          const float* __restrict__ shi,
                          const float* __restrict__ slo,
                          const float* __restrict__ gmhi,
                          const float* __restrict__ gmlo, int ns, int chunk,
                          float e2hi, float e2lo, float* __restrict__ part) {
  __shared__ float4 thi[kDfStage];
  __shared__ float4 tlo[kDfStage];
  __shared__ float red[kDfLanes][6][kDfRows];
  const int r = threadIdx.x % kDfRows;
  const int lane = threadIdx.x / kDfRows;
  const int i = blockIdx.x * kDfRows + r;
  const int c = blockIdx.y;
  const bool live = i < nr;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  const float3 xh = live ? df_row3(rhi, i) : zero;
  const float3 xl = live ? df_row3(rlo, i) : zero;
  const df eps2 = {e2hi, e2lo};
  const df z = {0.f, 0.f};
  df3 a = {z, z, z};
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, ns);
  for (int s0 = c0; s0 < c1; s0 += kDfStage) {
    const int j = s0 + threadIdx.x;
    if (j < c1) {
      thi[threadIdx.x] = df_src4(shi, j, gmhi[j]);
      tlo[threadIdx.x] = df_src4(slo, j, gmlo[j]);
    }
    __syncthreads();
    const int m = min(kDfStage, c1 - s0);
#pragma unroll 2
    for (int k = lane; k < m; k += kDfLanes)
      df_accel_pair<GUARDED>(thi[k], tlo[k], xh, xl, eps2, a);
    __syncthreads();
  }
  red[lane][0][r] = a.x.hi;
  red[lane][1][r] = a.y.hi;
  red[lane][2][r] = a.z.hi;
  red[lane][3][r] = a.x.lo;
  red[lane][4][r] = a.y.lo;
  red[lane][5][r] = a.z.lo;
  __syncthreads();
  if (live) df_reduce_lanes<3>(red, lane, r, c, i, nr, part);
}

}  // namespace

// Floats of scratch the launch needs: six per row and source chunk.
extern "C" long long ocn_rows_accel_df_scratch(int nr, int ns) {
  if (nr <= 0 || ns <= 0) return 0;
  int chunk, nchunks;
  ocn::df_plan(nr, ns, chunk, nchunks);
  return 6LL * nchunks * nr;
}

// rhi, rlo (nr, 3), shi, slo (ns, 3), gmhi, gmlo (ns,), ahi and alo (nr, 3)
// are contiguous f32 on the device; part holds
// ocn_rows_accel_df_scratch(nr, ns) floats. Returns cudaGetLastError()
// after the launches.
extern "C" int ocn_rows_accel_df(const float* rhi, const float* rlo, int nr,
                                 const float* shi, const float* slo,
                                 const float* gmhi, const float* gmlo, int ns,
                                 float e2hi, float e2lo, int guarded,
                                 float* part, float* ahi, float* alo,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    cudaMemsetAsync(ahi, 0, sizeof(float) * 3 * nr, s);
    cudaMemsetAsync(alo, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  int chunk, nchunks;
  ocn::df_plan(nr, ns, chunk, nchunks);
  const dim3 grid((nr + kDfRows - 1) / kDfRows, nchunks);
  if (guarded)
    rows_accel_df_partial<true><<<grid, kDfThreads, 0, s>>>(
        rhi, rlo, nr, shi, slo, gmhi, gmlo, ns, chunk, e2hi, e2lo, part);
  else
    rows_accel_df_partial<false><<<grid, kDfThreads, 0, s>>>(
        rhi, rlo, nr, shi, slo, gmhi, gmlo, ns, chunk, e2hi, e2lo, part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return ocn::df_launch_reduce<3>(part, nr, nchunks, ahi, alo, nullptr,
                                  nullptr, s);
}
