// K2: pair-symmetric softened self-gravity of N particles, with an
// optional potential output. Each unordered pair {i, j} is computed once:
// the action goes to row i and the reaction (-G m_i d inv^3, and
// -G m_i inv for the potential) to row j.
//
// Replaces the TPU triangle sweep _make_sym_kernel with _pair_accel (_OP_A)
// and _pair_phi (_OP_P) (oc_nbody_tpu/ops/pallas_pair.py:256, launched by
// _sym_call at :353 via accel_sym and accel_potential_sym,
// oc_nbody_tpu/ops/pallas_gravity.py:1736 and :1749).
//
// Bound on the card: 25 f32 flops (28 with the potential; an FMA counts 2;
// sym_rows.cuh:sym_pair_rb) and one rsqrt per pair (half the rsqrt of K1
// on the same N). Device memory is touched only by the partials below. The
// first design (one row
// a thread) spent three 16-byte shared-memory accesses a pair (source read,
// reaction read and write) and ran at the shared-memory rate, 2.8x its FMA
// bound. This one holds R rows a thread in registers (csrc/sym_rows.cuh),
// 48 / R shared bytes a pair, so from R = 4 on the issue rate of its 17
// instructions a pair bounds it.
//
// On the TPU the grid runs in order and each reaction is a sequential
// read-modify-write of the resident output. Here blocks run in parallel and
// the sum must be bitwise reproducible from run to run, so there are no
// float atomics; the reduction is two passes in a fixed order:
//
//  * rb::sym_tiles: tiles of TE = 128 R rows; one block of 128 threads per
//    tile pair (I, J), I <= J, and column part s < S: the block's rows are
//    tile I and its columns the s-th of S equal parts of tile J. Off the
//    diagonal (I < J) the sweep is pair-symmetric (rb::sweep_pairs); a
//    diagonal tile (I == J) adds to rows only, every pair in both
//    directions, as on the TPU (pallas_pair.py:259-260): the self pair adds
//    nothing to the acceleration and the softened self term -G m/eps to the
//    potential, which the wrapper removes with self_phi. The block writes
//    its row partial to slot I + (J - I) S + s of tile I and, off the
//    diagonal, its columns' reaction partials to slot I of tile J.
//  * rb::partials_reduce: row r of tile X sums its X + (nt - X) S slots in
//    slot order.
//
// The geometry (R, S) is chosen from N alone (rb::sym_geometry), so two
// launches on the same N are bitwise equal: the most rows a thread that
// still gives enough blocks to fill the card, with the fewest splits; S > 1
// splits a tile pair's columns over S blocks where N is too small for R
// rows a thread to fill the card otherwise (N = 8,192 runs R = 2, S = 2).
// Scratch is nt x nt S x TE float4, 16 N nt S bytes (nt = ceil(N / TE)):
// 67 MB at N = 65,536 and 1.07 GB at 262,144 with R = 8, S = 1. Every slot
// a row of the output reads is written exactly once per call, so scratch
// needs no clearing. N need not be a multiple of TE: rows and columns past N
// are masked, and nothing is padded.

#include "sym_rows.cuh"

namespace rb = ocn::rb;

// The tile edge of K3 and K7 (pair.cuh:kSymTile); they size scratch as
// nt * nt * T slots with nt = ceil(n / T).
extern "C" int ocn_sym_tile() { return ocn::kSymTile; }

// K2's geometry at N = n, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_sym_geometry(int n) { return rb::sym_geometry(n); }

// Floats of scratch K2 needs at N = n in geometry geom (0: its own); -1
// for a geometry not compiled.
extern "C" long long ocn_sym_scratch(int n, int geom) {
  return rb::sym_scratch_floats(n, geom);
}

// K2 in geometry geom (0: ocn_sym_geometry(n), the one every caller of the
// port takes). pos (n, 3), mass (n,) and acc (n, 3) are contiguous f32 on
// the device; phi (n,) may be null, and then no potential is computed;
// scratch holds ocn_sym_scratch(n, geom) floats. Returns
// cudaGetLastError() after both launches, cudaErrorInvalidValue for a
// geometry not compiled.
extern "C" int ocn_sym_accel(const float* pos, const float* mass, int n,
                             float G, float eps2, int guarded, int geom,
                             void* scratch, float* acc, float* phi,
                             void* stream) {
  return rb::sym_accel<rb::F32>({pos, mass, n, G}, eps2, guarded, geom,
                                scratch, acc, phi, stream);
}
