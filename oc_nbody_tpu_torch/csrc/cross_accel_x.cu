// K15: softened gravity between two DISJOINT sets A (nA rows) and B (nB
// sources) at the extended (hi/lo) precision tier, each pair once, with an
// optional raw potential output: the action of B goes to A's rows and the
// reaction (-G m_a s inv^3, and -G m_a inv for the potential) to B's. The
// sets share no particle, so there is no self pair and no self term.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_accel_x
// (_OP_AX) and _pair_phi_x (_OP_PX) (oc_nbody_tpu/ops/pallas_pair.py:296,
// :174, :182, launched by _cross_call at :369). The JAX package runs it for
// every unordered chunk pair (i < j) of the chunked extended
// self-interaction past STREAM_N (_sym_chunked_generic :443, via
// accel_sym_x_chunked and accel_potential_sym_x_chunked,
// oc_nbody_tpu/ops/pallas_gravity.py:1896, :1913) and for the disjoint-set
// forms accel_cross_pair_x_hilo and accel_potential_cross_pair_x_hilo
// (:2170, :2185).
//
// Both sets arrive as (hi, lo) f32 planes of f64 positions that the caller
// centred ONCE for the whole particle set and split in f64 (a centring per
// chunk would break the hi/lo invariant across chunks); gm is (G m in f64)
// rounded to f32. The pair is K6's, pair.cuh:sym_pair_x with its rsqrt
// seed taken by inv_r_ftz.
//
// Bound on the card: 44 f32 flops (46 with the potential; an FMA counts 2)
// and one rsqrt per pair. Device memory is touched only by the partials.
// The first design (one row a thread) spent 64 shared bytes a pair and
// ran at the shared-memory rate; this one holds R rows a thread in
// registers (csrc/sym_rows.cuh, the Ext tier), 64 / R bytes a pair, so
// from R = 4 on the issue rate of the pair bounds it, as K6.
//
// Design: K12's (csrc/cross_accel.cu) with the extended tier's rows and
// sources: one block per tile pair over all ntA x ntB pairs (A-tiles of TA
// = 128 R rows, B-tiles of TA / S columns), no triangle and no diagonal
// case; row partials to scA[I][J], the warps' reaction partials in warp
// order to scB[J][I], then rb::partials_reduce once per set in slot order.
// No float atomics; the geometry (R, S) comes from (nA, nB) alone
// (rb::cross_geometry), so two launches are bitwise equal. Scratch is K12's
// layout, ntA x ntB x (TA + TB) float4: 0.30 GB at nA = nB = 98,304
// (CHUNK_SYMX; R = 8, S = 1), where the first design needed 2.4 GB; the
// caller allocates it once per evaluation. Ragged nA and nB are masked, not
// padded; scratch offsets are size_t.
// Registers (ptxas -v, sm_90a): R = 8 128, R = 4 72, R = 2 48-56, R = 1 32,
// no spills in any geometry; 12,288 bytes of shared memory a block.

#include "sym_rows.cuh"

namespace rb = ocn::rb;

// K15's geometry on nA x nB, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_cross_x_geometry(int nA, int nB) {
  return rb::cross_geometry(nA, nB);
}

// Floats of scratch K15 needs on nA x nB in geometry geom (0: its own); -1
// for a geometry not compiled.
extern "C" long long ocn_cross_x_scratch(int nA, int nB, int geom) {
  return rb::cross_scratch_floats(nA, nB, geom);
}

// K15 in geometry geom (0: ocn_cross_x_geometry(nA, nB), the one every
// caller of the port takes). hiA, loA (nA, 3), gmA (nA,), hiB, loB (nB, 3),
// gmB (nB,), accA (nA, 3) and accB (nB, 3) are contiguous f32 on the
// device, the planes split under one centring; scratch holds at least
// ocn_cross_x_scratch(nA, nB, geom) floats. phiA and phiB are both null (no
// potential) or both given. Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a geometry not compiled.
extern "C" int ocn_cross_accel_x(const float* hiA, const float* loA,
                                 const float* gmA, int nA, const float* hiB,
                                 const float* loB, const float* gmB, int nB,
                                 float eps2, int guarded, int geom,
                                 void* scratch, float* accA, float* phiA,
                                 float* accB, float* phiB, void* stream) {
  return rb::cross_accel<rb::Ext>({hiA, loA, gmA, nA}, {hiB, loB, gmB, nB},
                                  eps2, guarded, geom, scratch, accA, phiA,
                                  accB, phiB, stream);
}
