// K8: one-sided softened gravity of a row set from a source set at the
// extended (hi/lo) precision tier, with an optional raw potential output
// (rows need not equal sources).
//
// Replaces the TPU row sweeps _accel_kernel_x
// (oc_nbody_tpu/ops/pallas_gravity.py:1062, launched by accel_rows_x_hilo at
// :1455) and _accel_phi_kernel_x (:1132, launched by
// accel_potential_rows_x_hilo at :1517).
//
// Rows and sources arrive as (hi, lo) f32 planes of f64 coordinates that
// the caller centred once, on one centre for both sets, and split in f64;
// gm is (G m in f64) rounded to f32. The pair arithmetic is
// pair.cuh:row_pair_x.
//
// Bound on the card: 36 f32 flops (37 with the potential; an FMA counts 2)
// and one rsqrtf per pair, while each source is read from device memory
// once per block (28 bytes per 128 pairs), so the kernel is bound by the
// FMA pipe, not by memory. Design: K1's (rows_accel.cu). One thread per row
// keeps the row's hi and lo and its accumulators in registers; the block
// stages a tile of sources in shared memory as two float4, (hi, G m) and
// (lo, 0), and every thread reads the same entry in turn (a broadcast).
// Each source tile is summed into its own partial before it joins the row's
// total, which keeps the f32 sum over many sources inside the tier's error
// budget. The ragged last tile is masked by the loop bound; rows past nr
// compute and store nothing, so no input is padded.

#include "pair.cuh"

namespace {

constexpr int kThreads = 128;

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    rows_accel_x(const float* __restrict__ rhi, const float* __restrict__ rlo,
                 int nr, const float* __restrict__ shi,
                 const float* __restrict__ slo, const float* __restrict__ gm,
                 int ns, float eps2, float* __restrict__ acc,
                 float* __restrict__ phi) {
  __shared__ float4 thi[kThreads];
  __shared__ float4 tlo[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nr;
  float3 xi = make_float3(0.f, 0.f, 0.f), li = make_float3(0.f, 0.f, 0.f);
  if (live) {
    xi = make_float3(rhi[3 * i], rhi[3 * i + 1], rhi[3 * i + 2]);
    li = make_float3(rlo[3 * i], rlo[3 * i + 1], rlo[3 * i + 2]);
  }
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
      thi[threadIdx.x] =
          make_float4(shi[3 * j], shi[3 * j + 1], shi[3 * j + 2], gm[j]);
      tlo[threadIdx.x] =
          make_float4(slo[3 * j], slo[3 * j + 1], slo[3 * j + 2], 0.f);
    }
    __syncthreads();
    float px = 0.f, py = 0.f, pz = 0.f, pp = 0.f;
    const int m = min(kThreads, ns - j0);
    if (m == kThreads) {
#pragma unroll 8
      for (int k = 0; k < kThreads; ++k)
        ocn::row_pair_x<WITH_PHI, GUARDED>(thi[k], tlo[k], xi, li, eps2, px,
                                           py, pz, pp);
    } else {
      for (int k = 0; k < m; ++k)
        ocn::row_pair_x<WITH_PHI, GUARDED>(thi[k], tlo[k], xi, li, eps2, px,
                                           py, pz, pp);
    }
    ax += px;
    ay += py;
    az += pz;
    ph += pp;
    __syncthreads();
  }
  if (live) {
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
    if (WITH_PHI) phi[i] = -ph;
  }
}

template <bool WITH_PHI, bool GUARDED>
void launch(const float* rhi, const float* rlo, int nr, const float* shi,
            const float* slo, const float* gm, int ns, float eps2, float* acc,
            float* phi, cudaStream_t stream) {
  const int blocks = (nr + kThreads - 1) / kThreads;
  rows_accel_x<WITH_PHI, GUARDED><<<blocks, kThreads, 0, stream>>>(
      rhi, rlo, nr, shi, slo, gm, ns, eps2, acc, phi);
}

}  // namespace

// rhi, rlo (nr, 3), shi, slo (ns, 3), gm (ns,) and acc (nr, 3) are
// contiguous f32 on the device; phi (nr,) may be null, and then no
// potential is computed. Returns cudaGetLastError() after the launch.
extern "C" int ocn_rows_accel_x(const float* rhi, const float* rlo, int nr,
                                const float* shi, const float* slo,
                                const float* gm, int ns, float eps2,
                                int guarded, float* acc, float* phi,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr > 0) {
    if (phi != nullptr) {
      if (guarded)
        launch<true, true>(rhi, rlo, nr, shi, slo, gm, ns, eps2, acc, phi, s);
      else
        launch<true, false>(rhi, rlo, nr, shi, slo, gm, ns, eps2, acc, phi,
                            s);
    } else {
      if (guarded)
        launch<false, true>(rhi, rlo, nr, shi, slo, gm, ns, eps2, acc, phi,
                            s);
      else
        launch<false, false>(rhi, rlo, nr, shi, slo, gm, ns, eps2, acc, phi,
                             s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
