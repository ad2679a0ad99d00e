// K16: softened accel + jerk between two DISJOINT sets A (nA rows) and B
// (nB sources) at the extended (hi/lo) precision tier, each pair once: with
// w = G m_b inv^3, rv = s.dv and B = dv - 3 rv inv^2 s, A's row gets (w s,
// w B) and B's the reaction -G m_a inv^3 (s, B). No self pair exists
// between disjoint sets.
//
// Replaces the TPU cross-pair sweep _make_cross_kernel with _pair_jerk_x
// (_OP_JX) (oc_nbody_tpu/ops/pallas_pair.py:296 and :202, launched by
// _cross_call at :369), run for every unordered chunk pair of the chunked
// extended accel + jerk self-interaction past STREAM_N
// (accel_jerk_sym_x_chunked, oc_nbody_tpu/ops/pallas_gravity.py:1932) and
// by accel_jerk_cross_pair_x_hilo (:2201).
//
// Positions and velocities arrive as (hi, lo) f32 planes of the f64 state,
// each centred ONCE for the whole set and split in f64 by the caller; gm is
// (G m in f64) rounded to f32. The pair is K7's, pair.cuh:sym_jerk_pair_x,
// to the letter but for its rsqrt seed, taken by inv_r_ftz (FTZ = true):
// the same bits on every u it sees (a normal u, or one the guard zeroes),
// three instructions fewer a pair.
//
// Bound on the card: 77 f32 flops (an FMA counts 2) and one rsqrtf per
// pair. Device memory is touched only by the partials. The first design
// (one row a thread, K7's block) spent 112 shared bytes a pair (four
// 16-byte source reads, a 16- and an 8-byte reaction read and write) and
// ran at the shared-memory rate; this one holds R rows a thread in
// registers (csrc/jerk_rows.cuh), 112 / R bytes a pair, so from R = 4 on
// the issue rate of the pair bounds it.
//
// Design: K13's (csrc/cross_jerk.cu) with the extended tier's rows (twelve
// coordinates, G m and six sums a row) and sources (four float4 planes in
// shared memory): one block per tile pair, row partials to slot (I, J) of
// A's planes, the warps' reaction partials in warp order to slot (J, I) of
// B's, then ocn::tile_reduce_jerk (pair.cuh) once per set in slot order.
// No float atomics; the geometry (R, S) comes from (nA, nB) alone, so two
// launches are bitwise equal. Scratch is ntA x ntB x (TA + TB) slots of six
// floats: 0.25 GB at nA = nB = 73,728 (CHUNK_SYMXJ; R = 8, S = 1), where
// the first design needed 2.0 GB; the caller allocates it once per
// evaluation. Ragged nA and nB are masked, not padded; scratch offsets are
// size_t.
// Registers (ptxas -v, sm_90a): R = 8 254, R = 4 128, R = 2 72, R = 1 48, no
// spills (with the rsqrtf seed R = 4 spilled 8 bytes under the guard);
// 20,480 bytes of shared memory a block.

#include "jerk_rows.cuh"

namespace {

namespace rbj = ocn::rbj;

rbj::Ext::Set set(const float* hi, const float* lo, const float* vhi,
                  const float* vlo, const float* gm, int n) {
  return {hi, lo, vhi, vlo, gm, n};
}

}  // namespace

// K16's geometry on nA x nB, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_cross_jerk_x_geometry(int nA, int nB) {
  return ocn::rb::cross_geometry(nA, nB);
}

// Floats of scratch K16 needs on nA x nB in geometry geom (0: its own);
// -1 for a geometry not compiled.
extern "C" long long ocn_cross_jerk_x_scratch(int nA, int nB, int geom) {
  return rbj::scratch_floats(nA, nB, geom);
}

// K16 in geometry geom (0: ocn_cross_jerk_x_geometry(nA, nB), the one
// every caller of the port takes). hiA, loA, vhiA, vloA (nA, 3), gmA (nA,),
// the same four planes of B (nB, 3), gmB (nB,), accA, jerkA (nA, 3) and
// accB, jerkB (nB, 3) are contiguous f32 on the device, the planes split
// under one centring of positions and one of velocities; scratch holds at
// least ocn_cross_jerk_x_scratch(nA, nB, geom) floats. Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for a
// geometry not compiled.
extern "C" int ocn_cross_jerk_x(const float* hiA, const float* loA,
                                const float* vhiA, const float* vloA,
                                const float* gmA, int nA, const float* hiB,
                                const float* loB, const float* vhiB,
                                const float* vloB, const float* gmB, int nB,
                                float eps2, int guarded, int geom,
                                void* scratch, float* accA, float* jerkA,
                                float* accB, float* jerkB, void* stream) {
  return rbj::cross_jerk<rbj::Ext>(
      set(hiA, loA, vhiA, vloA, gmA, nA), set(hiB, loB, vhiB, vloB, gmB, nB),
      eps2, guarded, geom, scratch, accA, jerkA, accB, jerkB, stream);
}
