// K6: pair-symmetric softened self-gravity of N particles at the extended
// (hi/lo) precision tier, with an optional raw potential output. Each
// unordered pair {i, j} is computed once: the action goes to row i and the
// reaction (-G m_i s inv^3, and -G m_i inv for the potential) to row j.
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_accel_x
// (_OP_AX) and _pair_phi_x (_OP_PX) (oc_nbody_tpu/ops/pallas_pair.py:256,
// :174, :182, launched by _sym_call via accel_sym_x and
// accel_potential_sym_x, oc_nbody_tpu/ops/pallas_gravity.py:1781 and :1796).
//
// Positions arrive as (hi, lo) f32 planes of the f64 coordinates, centred
// once and split in f64 by the caller; gm is (G m in f64) rounded to f32.
// The pair is pair.cuh:sym_pair_x (the separation and Newton-refined
// inverse of hilo_sep_inv), its rsqrt seed taken by inv_r_ftz.
//
// Bound on the card: 44 f32 flops (46 with the potential; an FMA counts 2)
// and one rsqrt per unique pair. Device memory is touched only by the
// partials. The first design (one row a thread) spent 64 shared bytes a
// pair (the source's hi and lo planes, the reaction's read and write) and
// ran at the shared-memory rate; this one holds R rows a thread in
// registers (csrc/sym_rows.cuh, the Ext tier), 64 / R bytes a pair, so
// from R = 4 on the issue rate of the pair's 32 FP32 instructions and one
// MUFU bounds it.
//
// Design: K2's (csrc/sym_accel.cu) with the extended tier's rows and
// sources. Tiles of TE = 128 R rows; one block per tile pair (I, J), I <=
// J, and column part s < S. Off the diagonal the sweep is pair-symmetric;
// a diagonal tile adds to rows only, every pair in both directions
// (row_pair_x), so the softened self term -G m/eps stays in the potential
// (the raw potential of this tier; the caller adds self_phi). Then
// rb::partials_reduce sums each row's slots in slot order. No float
// atomics; the geometry (R, S) comes from N alone, K2's rule
// (rb::sym_geometry), so two launches on the same N are bitwise equal.
// Scratch is K2's layout, nt x nt S x TE float4 (16 N nt S bytes): 0.27 GB
// at N = 131,072 (R = 8, S = 1), where the first design needed 2.1 GB.
// Every slot a row reads is written once per call. N need not be a
// multiple of TE.
// Registers (ptxas -v, sm_90a): R = 8 128, R = 4 74-80, R = 2 48-56, R = 1
// 32-34, no spills in any geometry; 12,288 bytes of shared memory a block.

#include "sym_rows.cuh"

namespace rb = ocn::rb;

// K6's geometry at N = n, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_sym_x_geometry(int n) { return rb::sym_geometry(n); }

// Floats of scratch K6 needs at N = n in geometry geom (0: its own); -1 for
// a geometry not compiled.
extern "C" long long ocn_sym_x_scratch(int n, int geom) {
  return rb::sym_scratch_floats(n, geom);
}

// K6 in geometry geom (0: ocn_sym_x_geometry(n), the one every caller of
// the port takes). hi, lo (n, 3), gm (n,) and acc (n, 3) are contiguous f32
// on the device; phi (n,) may be null, and then no potential is computed;
// scratch holds ocn_sym_x_scratch(n, geom) floats. Returns
// cudaGetLastError() after both launches, cudaErrorInvalidValue for a
// geometry not compiled.
extern "C" int ocn_sym_accel_x(const float* hi, const float* lo,
                               const float* gm, int n, float eps2,
                               int guarded, int geom, void* scratch,
                               float* acc, float* phi, void* stream) {
  return rb::sym_accel<rb::Ext>({hi, lo, gm, n}, eps2, guarded, geom,
                                scratch, acc, phi, stream);
}
