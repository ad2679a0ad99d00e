// K21: one step of the sharded ring's accel + jerk: one shard's rows, with
// their velocities, against the source slab circulating past them at this
// step (positions, velocities and G m), the step's sums then added into the
// shard's running (accel, jerk) by Kahan steps (or stored, at the
// evaluation's first step). A Hermite force evaluation over d shards is d
// launches per shard (ops/cuda_ring.py).
//
// K21 replaces the TPU ring kernel _ring_jerk_kernel
// (oc_nbody_tpu/ops/pallas_ring.py:202; launched by accel_jerk_ring at
// :375), which sweeps the row tiles against each circulating (7, N/d) slab
// with _sweep_t_jerk (pallas_gravity.py:801) and adds each step's tile sums
// into both outputs with _accumulate_t's Kahan step (:748-761). As in K20
// (ring_accel.cu), the schedule, the slab copies and the handshake are
// host-side streams and events, and the cross-step accumulation is the
// kernel's last pass over running sums kept in device memory.
//
// Bound on the card: 41 f32 flops (an FMA counts 2) and one rsqrtf per
// pair, pair.cuh:row_jerk_pair; the Kahan steps add 4 flops and 24 bytes of
// read-modify-write per row, component and step against ns pairs per row,
// so the FMA pipe binds. At c3 on a 4-shard mesh (N = 16,384) a launch is
// 4,096 x 4,096 pairs (10.3 us at the f32 peak), so a Hermite step's 16
// launches are host-launch bound, not pair bound.
//
// Design: K5's source-split first pass (rows_jerk_t.cuh) with G = 1 and the
// slab's G m plane as the mass, then rows_split.cuh:accumulate over six
// components: a row's bits do not depend on the launch's other rows, every
// launch is bitwise repeatable, and no float atomics are used. A slab slot
// is one contiguous buffer, positions (ns, 3), velocities (ns, 3), then G m
// (ns,): the JAX slab's seven planes in the order the kernel reads them.

#include "rows_jerk_t.cuh"

namespace {

template <bool GUARDED>
void launch(const float* rows, const float* vrows, int nr, const float* src,
            const float* svel, const float* gm, int ns, float eps2,
            int first, float* part, float* acc, float* acc_comp, float* jerk,
            float* jerk_comp, cudaStream_t s) {
  rows_jerk_t_partial<GUARDED, false>
      <<<ocn::split::partial_grid(nr, ns), kThreads, 0, s>>>(
          rows, vrows, nr, src, svel, gm, ns, ocn::split::chunk_size(ns),
          1.f, eps2, part);
  ocn::split::launch_accumulate<6, false>(part, nr, ns, first, acc,
                                          acc_comp, jerk, jerk_comp, s);
}

}  // namespace

// Floats of scratch a launch needs: six per row and source chunk.
extern "C" long long ocn_ring_jerk_scratch(int nr, int ns) {
  return ocn::split::scratch_floats(nr, ns, 6);
}

// rows, vrows (nr, 3), src, svel (ns, 3), gm (ns,) = G m, and acc,
// acc_comp, jerk, jerk_comp (nr, 3) are contiguous f32 on the device.
// first != 0 stores the step's sums (the compensations, where not null, are
// zeroed); otherwise they are added by Kahan steps and the compensations
// must not be null. part holds ocn_ring_jerk_scratch(nr, ns) floats.
// Returns cudaGetLastError() after the launches.
extern "C" int ocn_ring_jerk(const float* rows, const float* vrows, int nr,
                             const float* src, const float* svel,
                             const float* gm, int ns, float eps2,
                             int guarded, int first, float* part, float* acc,
                             float* acc_comp, float* jerk, float* jerk_comp,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr <= 0) return static_cast<int>(cudaGetLastError());
  if (ns <= 0) {
    float* outs[4] = {acc, acc_comp, jerk, jerk_comp};
    if (first)
      for (float* p : outs)
        if (p != nullptr) cudaMemsetAsync(p, 0, sizeof(float) * 3 * nr, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (guarded)
    launch<true>(rows, vrows, nr, src, svel, gm, ns, eps2, first, part, acc,
                 acc_comp, jerk, jerk_comp, s);
  else
    launch<false>(rows, vrows, nr, src, svel, gm, ns, eps2, first, part, acc,
                  acc_comp, jerk, jerk_comp, s);
  return static_cast<int>(cudaGetLastError());
}
