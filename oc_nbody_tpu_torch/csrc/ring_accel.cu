// K20: one step of the sharded ring's accel, and with WITH_PHI its
// potential: one shard's rows against the source slab that is circulating
// past them at this step, the step's sum then added into the shard's
// running sums by a Kahan step (or stored, at the evaluation's first step).
// A ring evaluation over d shards is d launches per shard, the slabs
// arriving in the order s, s - 1, ..., s - d + 1 (ops/cuda_ring.py).
//
// K20 replaces the TPU ring kernels _ring_kernel and, as K20<WITH_PHI>,
// _ring_phi_kernel (oc_nbody_tpu/ops/pallas_ring.py:135, :169; launched by
// accel_ring and accel_potential_ring at :257, :316). Those hold the whole
// D-step ring in one kernel: each step sweeps the row tiles against one
// slab with _sweep_t_accel / _sweep_t_phi (pallas_gravity.py:763, :869),
// whose _accumulate_t (:748-761) stores the first step's tile sums and adds
// each later step's into the output by a Kahan step (compensated whenever
// d > 1, COMPENSATED's default), while a remote copy hands the slab on to
// the right neighbour. Here the ring's schedule, its copies and its
// semaphores are host-side streams and events (cuda_ring.py), and the
// kernel is one step, with the cross-step accumulation inside its last
// pass: the running sums and their compensations live in device memory
// across the launches of one evaluation.
//
// Bound on the card: 18 f32 flops (19 with the potential; an FMA counts 2)
// and one rsqrtf per pair, pair.cuh:row_pair; each slab source is read once
// per block of 32 rows, and the Kahan step adds 4 flops and 24 (32) bytes
// of read-modify-write per row and component per step, against ns pairs
// per row: the FMA pipe binds. At c5 on a 4-shard mesh (N = 131,072) a
// launch is 32,768 x 32,768 pairs, 0.29 ms at the H100's f32 peak.
//
// Design: K18's source-split first pass (rows_accel_t.cuh, the layout of
// rows_split.cuh) with G = 1 and the slab's G m plane as the mass; a row's
// bits do not depend on the launch's other rows, and the chunk boundaries
// and both summation orders are fixed by ns, so every launch is bitwise
// repeatable whatever the other streams are doing. Pass 2 is
// rows_split.cuh:accumulate, the step's chunk partials summed plainly in
// chunk order and then added by pair.cuh:kahan_add (__fadd_rn /
// __fsub_rn, which --fmad cannot contract). A slab slot is one contiguous
// buffer, positions (ns, 3) then G m (ns,), so a step's hand-on is one copy;
// at d = 1 the kernel reads the shard's own planes and stores.

#include "rows_accel_t.cuh"

namespace {

template <bool WITH_PHI, bool GUARDED>
void launch(const float* rows, int nr, const float* src, const float* gm,
            int ns, float eps2, int first, float* part, float* acc,
            float* acc_comp, float* phi, float* phi_comp, cudaStream_t s) {
  rows_accel_t_partial<WITH_PHI, GUARDED, false>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rows, nr, src, gm, ns, ocn::split::chunk_size(ns), 1.f, eps2,
          part);
  ocn::split::launch_accumulate<WITH_PHI ? 4 : 3, true>(
      part, nr, ns, first, acc, acc_comp, phi, phi_comp, s);
}

template <bool WITH_PHI>
void dispatch_guard(bool guarded, const float* rows, int nr,
                    const float* src, const float* gm, int ns, float eps2,
                    int first, float* part, float* acc, float* acc_comp,
                    float* phi, float* phi_comp, cudaStream_t s) {
  if (guarded)
    launch<WITH_PHI, true>(rows, nr, src, gm, ns, eps2, first, part, acc,
                           acc_comp, phi, phi_comp, s);
  else
    launch<WITH_PHI, false>(rows, nr, src, gm, ns, eps2, first, part, acc,
                            acc_comp, phi, phi_comp, s);
}

}  // namespace

// Floats of scratch a launch needs: three per row and source chunk, four
// with the potential.
extern "C" long long ocn_ring_accel_scratch(int nr, int ns, int with_phi) {
  return ocn::split::scratch_floats(nr, ns, with_phi ? 4 : 3);
}

// rows (nr, 3), src (ns, 3), gm (ns,) = G m, acc and acc_comp (nr, 3) are
// contiguous f32 on the device; phi and phi_comp (nr,) may be null, and
// then no potential is computed. first != 0 stores the step's sums (the
// compensations, where not null, are zeroed); otherwise they are added into
// (acc, acc_comp) and (phi, phi_comp) by a Kahan step, and the
// compensations must not be null. The potential keeps the softened self
// term of a row that is also a source; the caller adds self_phi. part holds
// ocn_ring_accel_scratch(nr, ns, phi != null) floats. Returns
// cudaGetLastError() after the launches.
extern "C" int ocn_ring_accel(const float* rows, int nr, const float* src,
                              const float* gm, int ns, float eps2,
                              int guarded, int first, float* part,
                              float* acc, float* acc_comp, float* phi,
                              float* phi_comp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    if (first) {
      cudaMemsetAsync(acc, 0, sizeof(float) * 3 * nr, s);
      if (acc_comp != nullptr)
        cudaMemsetAsync(acc_comp, 0, sizeof(float) * 3 * nr, s);
      if (phi != nullptr) cudaMemsetAsync(phi, 0, sizeof(float) * nr, s);
      if (phi_comp != nullptr)
        cudaMemsetAsync(phi_comp, 0, sizeof(float) * nr, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool g = guarded != 0;
  if (phi != nullptr)
    dispatch_guard<true>(g, rows, nr, src, gm, ns, eps2, first, part, acc,
                         acc_comp, phi, phi_comp, s);
  else
    dispatch_guard<false>(g, rows, nr, src, gm, ns, eps2, first, part, acc,
                          acc_comp, phi, phi_comp, s);
  return static_cast<int>(cudaGetLastError());
}
