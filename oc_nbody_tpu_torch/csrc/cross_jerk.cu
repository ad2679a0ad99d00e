// K13: softened accel + jerk between two DISJOINT sets A (nA rows) and B
// (nB sources), each pair once: with w = G m_b inv^3, rv = d.dv and B = dv
// - 3 rv inv^2 d, A's row gets (w d, w B) and B's the reaction -G m_a inv^3
// (d, B). No self pair exists between disjoint sets.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_jerk
// (_OP_J) (oc_nbody_tpu/ops/pallas_pair.py:296 and :137, launched by
// _cross_call at :369), run for every unordered chunk pair of the chunked
// accel + jerk self-interaction past STREAM_N (accel_jerk_sym_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1876) and by accel_jerk_cross_pair
// (:2140).
//
// Bound on the card: 53 f32 flops (an FMA counts 2) and one rsqrt per pair
// (jerk_rows.cuh:sym_jerk_pair_rb, 33 FP32 instructions and the MUFU).
// Device memory is touched only by the partials. The first design (one row
// a thread, K3's block) spent 80 shared bytes a pair and ran at the
// shared-memory rate; this one holds R rows a thread in registers
// (csrc/jerk_rows.cuh), 80 / R bytes a pair, so from R = 4 on the issue
// rate of the pair bounds it.
//
// Design: K12's plan (csrc/cross_accel.cu) on jerk_rows.cuh's rows, over all
// ntA x ntB tile pairs. A-tiles hold TA = 128 R rows, B-tiles TB = TA / S
// columns. Two passes, no float atomics, fixed order:
//
//  * rbj::cross_jerk_tiles: one block of 128 threads per tile pair (I, J),
//    sweeping A-tile I against B-tile J pair-symmetrically. Its row
//    partials go to slot (I, J) of A's planes, its columns' reaction
//    partials, summed over its warps in warp order, to slot (J, I) of B's.
//  * ocn::tile_reduce_jerk (pair.cuh), once per set, partials in slot order.
//
// The geometry (R, S) is chosen from (nA, nB) alone (ocn_cross_jerk_geometry:
// the most rows a thread that still gives enough blocks to fill the card),
// so two launches on the same sets are bitwise equal. Scratch is ntA x ntB
// x (TA + TB) slots of six floats: 0.45 GB at nA = nB = 98,304 (R = 8, S =
// 1), the jerk chunk of the chunked self-interaction, where the first
// design needed 3.6 GB; the caller allocates it once per evaluation. Ragged
// nA and nB are masked, not padded; scratch offsets are size_t.
// Registers (ptxas -v, sm_90a): R = 8 168, R = 4 96, R = 2 64, R = 1 42, no
// spills; 16,384 bytes of shared memory a block.

#include "jerk_rows.cuh"

namespace {

namespace rbj = ocn::rbj;

rbj::F32::Set set(const float* pos, const float* vel, const float* mass,
                  int n, float G) {
  return {pos, vel, mass, n, G};
}

}  // namespace

// K13's geometry on nA x nB, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_cross_jerk_geometry(int nA, int nB) {
  return ocn::rb::cross_geometry(nA, nB);
}

// Floats of scratch K13 needs on nA x nB in geometry geom (0: its own);
// -1 for a geometry not compiled.
extern "C" long long ocn_cross_jerk_scratch(int nA, int nB, int geom) {
  return rbj::scratch_floats(nA, nB, geom);
}

// K13 in geometry geom (0: ocn_cross_jerk_geometry(nA, nB), the one every
// caller of the port takes). posA, velA (nA, 3), massA (nA,), posB, velB
// (nB, 3), massB (nB,), accA, jerkA (nA, 3) and accB, jerkB (nB, 3) are
// contiguous f32 on the device, positions and velocities centred in one
// frame; scratch holds at least ocn_cross_jerk_scratch(nA, nB, geom)
// floats. Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a geometry not compiled.
extern "C" int ocn_cross_jerk(const float* posA, const float* velA,
                              const float* massA, int nA, const float* posB,
                              const float* velB, const float* massB, int nB,
                              float G, float eps2, int guarded, int geom,
                              void* scratch, float* accA, float* jerkA,
                              float* accB, float* jerkB, void* stream) {
  return rbj::cross_jerk<rbj::F32>(
      set(posA, velA, massA, nA, G), set(posB, velB, massB, nB, G), eps2,
      guarded, geom, scratch, accA, jerkA, accB, jerkB, stream);
}
