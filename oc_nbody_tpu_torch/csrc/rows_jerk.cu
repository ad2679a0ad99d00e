// K4: one-sided softened accel + jerk of a row set from a source set (rows
// need not equal sources): the Hermite force evaluation below the
// pair-symmetric crossover, and the one-sided form a block stepper's active
// rows use.
//
// Replaces the TPU row-grid kernel _accel_jerk_kernel
// (oc_nbody_tpu/ops/pallas_gravity.py:294, launched by accel_jerk_rows at
// :347).
//
// Bound on the card: 41 f32 flops (an FMA counts 2) and one rsqrtf per
// pair (the Pallas cost estimate counts 50), while each source is read
// from device memory once per block (32 bytes per 128 pairs), so the kernel
// is bound by the FMA pipe, not by memory. Design: K1's
// (csrc/rows_accel.cu). One thread per row keeps the row's position,
// velocity and six sums in registers; the block stages a tile of sources in shared memory as float4(x, y, z, G m)
// and float4(vx, vy, vz, 0), and every thread reads the same entry in turn
// (a broadcast, free of bank conflicts). The ragged last source tile is
// masked by the loop bound and rows past nr compute and store nothing, so
// no input is padded. Each source tile is summed into its own partial
// before it joins the row's total (a flat serial f32 sum over 65,536
// sources fails the 2e-5 bound; see rows_accel.cu).

#include "pair.cuh"

namespace {

constexpr int kThreads = 128;

template <bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    rows_jerk(const float* __restrict__ rows, const float* __restrict__ vrows,
              int nr, const float* __restrict__ src,
              const float* __restrict__ svel, const float* __restrict__ mass,
              int ns, float G, float eps2, float* __restrict__ acc,
              float* __restrict__ jerk) {
  __shared__ float4 tile[kThreads];
  __shared__ float4 vtile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nr;
  float3 xi = make_float3(0.f, 0.f, 0.f), vi = make_float3(0.f, 0.f, 0.f);
  if (live) {
    xi = make_float3(rows[3 * i], rows[3 * i + 1], rows[3 * i + 2]);
    vi = make_float3(vrows[3 * i], vrows[3 * i + 1], vrows[3 * i + 2]);
  }
  float3 a = make_float3(0.f, 0.f, 0.f), jk = make_float3(0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < ns; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
      tile[threadIdx.x] =
          make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], G * mass[j]);
      vtile[threadIdx.x] =
          make_float4(svel[3 * j], svel[3 * j + 1], svel[3 * j + 2], 0.f);
    }
    __syncthreads();
    // sum the tile into its own partial, then the partial into the row
    float3 pa = make_float3(0.f, 0.f, 0.f), pj = make_float3(0.f, 0.f, 0.f);
    const int m = min(kThreads, ns - j0);
    if (m == kThreads) {
#pragma unroll 8
      for (int k = 0; k < kThreads; ++k)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, pa, pj);
    } else {
      for (int k = 0; k < m; ++k)
        ocn::row_jerk_pair<GUARDED>(tile[k], vtile[k], xi, vi, eps2, pa, pj);
    }
    a.x += pa.x;
    a.y += pa.y;
    a.z += pa.z;
    jk.x += pj.x;
    jk.y += pj.y;
    jk.z += pj.z;
    __syncthreads();
  }
  if (live) {
    acc[3 * i] = a.x;
    acc[3 * i + 1] = a.y;
    acc[3 * i + 2] = a.z;
    jerk[3 * i] = jk.x;
    jerk[3 * i + 1] = jk.y;
    jerk[3 * i + 2] = jk.z;
  }
}

}  // namespace

// rows, vrows (nr, 3), src, svel (ns, 3), mass (ns,), acc and jerk (nr, 3)
// are contiguous f32 on the device. Returns cudaGetLastError() after the
// launch.
extern "C" int ocn_rows_jerk(const float* rows, const float* vrows, int nr,
                             const float* src, const float* svel,
                             const float* mass, int ns, float G, float eps2,
                             int guarded, float* acc, float* jerk,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr > 0) {
    const int blocks = (nr + kThreads - 1) / kThreads;
    if (guarded)
      rows_jerk<true><<<blocks, kThreads, 0, s>>>(rows, vrows, nr, src, svel,
                                                  mass, ns, G, eps2, acc,
                                                  jerk);
    else
      rows_jerk<false><<<blocks, kThreads, 0, s>>>(rows, vrows, nr, src, svel,
                                                   mass, ns, G, eps2, acc,
                                                   jerk);
  }
  return static_cast<int>(cudaGetLastError());
}
