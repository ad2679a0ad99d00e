// K12: softened gravity between two DISJOINT sets A (nA rows) and B (nB
// sources), each pair once, with an optional potential output: the action
// of B goes to A's rows and the reaction (-G m_a d inv^3, and -G m_a inv
// for the potential) to B's. The sets share no particle, so there is no
// self pair and no self term anywhere.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_accel
// (_OP_A) and _pair_phi (_OP_P) (oc_nbody_tpu/ops/pallas_pair.py:296,
// launched by _cross_call at :369). The JAX package runs it for every
// unordered chunk pair (i < j) of the chunked self-interaction past
// STREAM_N (_cross_accumulate :414 under _sym_chunked_generic :443, via
// accel_sym_chunked and accel_potential_sym_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1835, :1853) and for the disjoint-set
// forms accel_cross_pair and accel_potential_cross_pair (:2103, :2121).
//
// Bound on the card: the pair of K2, 25 f32 flops (28 with the potential;
// an FMA counts 2) and one rsqrt per pair (sym_rows.cuh:sym_pair_rb).
// Device memory is touched only by the partials below. As K2 (csrc/sym_accel.cu),
// the first design (one row a thread) ran at the shared-memory rate, 48
// bytes a pair; this one holds R rows a thread in registers
// (csrc/sym_rows.cuh), 48 / R bytes a pair, so from R = 4 on the issue
// rate of its 17 instructions a pair bounds it.
//
// Design: K2's register-blocked block over all ntA x ntB tile pairs, no
// triangle and no diagonal case. A-tiles hold TA = 128 R rows, B-tiles
// TB = TA / S columns. Two passes, no float atomics, fixed order:
//
//  * rb::cross_tiles: one block of 128 threads per tile pair (I, J), I < ntA,
//    J < ntB, sweeping A-tile I against B-tile J pair-symmetrically
//    (rb::sweep_pairs). The block writes its row partials to scA[I][J] and
//    its columns' reaction partials, summed over its warps in warp order,
//    to scB[J][I].
//  * rb::partials_reduce, once per set: A-row r of tile X sums scA[X][P][r]
//    for P = 0 .. ntB-1, B-row r of tile Y sums scB[Y][P][r] for P = 0 ..
//    ntA-1, in that order.
//
// The geometry (R, S) is chosen from (nA, nB) alone (rb::cross_geometry): the
// most rows a thread that still gives enough blocks to fill the card, with
// the narrowest B-tiles only where it must (16,384^2 runs R = 8, S = 4).
// So two launches on the same sets are bitwise equal. Scratch is ntA x ntB x (TA + TB) float4: 0.54 GB at nA =
// nB = 131,072 with R = 8, S = 1, the chunk of the chunked
// self-interaction; the caller allocates it once per evaluation and hands
// it to every chunk pair. Every slot a reduce reads is written once per
// call, so it needs no clearing. nA and nB need not be equal nor multiples
// of a tile: a row past nA is massless (its action is dropped, its
// reaction is zero), a column past nB is masked, and nothing is padded.
// Scratch offsets are size_t.

#include "sym_rows.cuh"

namespace rb = ocn::rb;

// K12's geometry on nA x nB, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_cross_geometry(int nA, int nB) {
  return rb::cross_geometry(nA, nB);
}

// Floats of scratch K12 needs on nA x nB in geometry geom (0: its own); -1
// for a geometry not compiled.
extern "C" long long ocn_cross_accel_scratch(int nA, int nB, int geom) {
  return rb::cross_scratch_floats(nA, nB, geom);
}

// K12 in geometry geom (0: ocn_cross_geometry(nA, nB), the one every
// caller of the port takes). posA (nA, 3), massA (nA,), posB (nB, 3),
// massB (nB,), accA (nA, 3) and accB (nB, 3) are contiguous f32 on the
// device, the positions centred in one frame; scratch holds at least
// ocn_cross_accel_scratch(nA, nB, geom) floats. phiA and phiB are both
// null (no potential) or both given. Returns cudaGetLastError() after the
// launches, cudaErrorInvalidValue for a geometry not compiled.
extern "C" int ocn_cross_accel(const float* posA, const float* massA, int nA,
                               const float* posB, const float* massB, int nB,
                               float G, float eps2, int guarded, int geom,
                               void* scratch, float* accA, float* phiA,
                               float* accB, float* phiB, void* stream) {
  return rb::cross_accel<rb::F32>({posA, massA, nA, G}, {posB, massB, nB, G},
                                  eps2, guarded, geom, scratch, accA, phiA,
                                  accB, phiB, stream);
}
