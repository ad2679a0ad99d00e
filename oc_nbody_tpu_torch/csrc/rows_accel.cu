// K1: one-sided softened gravity of a row set from a source set, with an
// optional potential output (rows need not equal sources).
//
// Replaces the TPU row-grid kernels _accel_kernel
// (oc_nbody_tpu/ops/pallas_gravity.py:110, launched by accel_rows at :175)
// and _accel_phi_kernel (:199, launched by accel_potential_rows at :264).
//
// Bound on the card: 18 f32 flops (19 with the potential; an FMA counts 2)
// and one rsqrtf per pair, while each source is read from device memory
// once per block (16 bytes per 128 pairs), so the kernel is bound by the
// FMA pipe, not by memory. Design: one thread per row keeps the row and its
// accumulators in registers; the block stages a tile of sources in shared
// memory as float4(x, y, z, G m) and every thread reads the same entry in
// turn (a broadcast, free of bank conflicts).
// The ragged last source tile is masked by the loop bound and rows past nr
// compute and store nothing, so no input is padded. Each source tile is
// summed into its own partial before it joins the row's total; one serial
// f32 sum over all 65,536 sources of the north star's unsoftened case
// measured 1e-4·max|a| off the f64 reference, past the 2e-5 bound.

#include "pair.cuh"

namespace {

constexpr int kThreads = 128;

template <bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(kThreads)
    rows_accel(const float* __restrict__ rows, int nr,
               const float* __restrict__ src, const float* __restrict__ mass,
               int ns, float G, float eps2, float* __restrict__ acc,
               float* __restrict__ phi) {
  __shared__ float4 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nr;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) {
    xi = rows[3 * i];
    yi = rows[3 * i + 1];
    zi = rows[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < ns)
      tile[threadIdx.x] =
          make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], G * mass[j]);
    __syncthreads();
    // sum the tile into its own partial, then the partial into the row:
    // two-level summation, as the TPU's per-tile partial sums
    float px = 0.f, py = 0.f, pz = 0.f, pp = 0.f;
    const int m = min(kThreads, ns - j0);
    if (m == kThreads) {
#pragma unroll 16
      for (int k = 0; k < kThreads; ++k)
        ocn::row_pair<WITH_PHI, GUARDED>(tile[k], xi, yi, zi, eps2, px, py,
                                         pz, pp);
    } else {
      for (int k = 0; k < m; ++k)
        ocn::row_pair<WITH_PHI, GUARDED>(tile[k], xi, yi, zi, eps2, px, py,
                                         pz, pp);
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
void launch(const float* rows, int nr, const float* src, const float* mass,
            int ns, float G, float eps2, float* acc, float* phi,
            cudaStream_t stream) {
  const int blocks = (nr + kThreads - 1) / kThreads;
  rows_accel<WITH_PHI, GUARDED><<<blocks, kThreads, 0, stream>>>(
      rows, nr, src, mass, ns, G, eps2, acc, phi);
}

}  // namespace

// rows (nr, 3), src (ns, 3), mass (ns,) and acc (nr, 3) are contiguous f32
// on the device; phi (nr,) may be null, and then no potential is computed.
// Returns cudaGetLastError() after the launch.
extern "C" int ocn_rows_accel(const float* rows, int nr, const float* src,
                              const float* mass, int ns, float G, float eps2,
                              int guarded, float* acc, float* phi,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr > 0) {
    if (phi != nullptr) {
      if (guarded)
        launch<true, true>(rows, nr, src, mass, ns, G, eps2, acc, phi, s);
      else
        launch<true, false>(rows, nr, src, mass, ns, G, eps2, acc, phi, s);
    } else {
      if (guarded)
        launch<false, true>(rows, nr, src, mass, ns, G, eps2, acc, phi, s);
      else
        launch<false, false>(rows, nr, src, mass, ns, G, eps2, acc, phi, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ocn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
