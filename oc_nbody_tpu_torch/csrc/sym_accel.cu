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
//  * sym_tiles: tiles of TE = 128 R rows; one block of 128 threads per tile
//    pair (I, J), I <= J, and column part s < S: the block's rows are tile
//    I and its columns the s-th of S equal parts of tile J. Off the
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
// The geometry (R, S) is chosen from N alone (sym_geometry), so two
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

namespace {

namespace rb = ocn::rb;

template <int R, bool WITH_PHI, bool GUARDED>
__global__ void __launch_bounds__(rb::kThreads)
    sym_tiles(const float* __restrict__ pos, const float* __restrict__ mass,
              int n, int nt, int S, float G, float eps2,
              float4* __restrict__ scratch) {
  __shared__ rb::Shared sh;
  constexpr int TE = R * rb::kThreads;
  const int width = TE / S;
  const int s = static_cast<int>(blockIdx.x % S);
  int I, J;
  ocn::tile_pair(blockIdx.x / S, nt, I, J);
  const size_t slots = static_cast<size_t>(nt) * S;  // slots a tile
  rb::Rows<R> w;
  rb::load_rows(w, pos, mass, I * TE, n, G);
  const int c0 = J * TE + s * width;
  if (I == J)
    rb::sweep_block<R, WITH_PHI, GUARDED, false>(w, sh, pos, mass, n, c0,
                                                 width, G, eps2, nullptr);
  else
    rb::sweep_block<R, WITH_PHI, GUARDED, true>(
        w, sh, pos, mass, n, c0, width, G, eps2,
        scratch + (J * slots + I) * TE + s * width);
  rb::store_rows(w, scratch + (I * slots + I + (J - I) * S + s) * TE, I * TE,
                 n);
}

int tiles(int n, int R) {
  const int te = R * rb::kThreads;
  return (n + te - 1) / te;
}

int sym_geometry(int n) {
  return rb::choose_geom([n](int R, int S) {
    const long long nt = tiles(n, R);
    return S * nt * (nt + 1) / 2;
  });
}

template <int R, bool WITH_PHI, bool GUARDED>
void launch(const float* pos, const float* mass, int n, int S, float G,
            float eps2, float4* scratch, float* acc, float* phi,
            cudaStream_t stream) {
  const int nt = tiles(n, R);
  const long long blocks = static_cast<long long>(S) * nt * (nt + 1) / 2;
  sym_tiles<R, WITH_PHI, GUARDED>
      <<<static_cast<unsigned>(blocks), rb::kThreads, 0, stream>>>(
          pos, mass, n, nt, S, G, eps2, scratch);
  constexpr int kR = ocn::kReduceThreads;
  rb::partials_reduce<WITH_PHI><<<(n + kR - 1) / kR, kR, 0, stream>>>(
      scratch, n, R * rb::kThreads, nt, S, acc, phi);
}

template <int R>
void launch_r(const float* pos, const float* mass, int n, int S, float G,
              float eps2, int guarded, float4* sc, float* acc, float* phi,
              cudaStream_t s) {
  if (phi != nullptr) {
    if (guarded)
      launch<R, true, true>(pos, mass, n, S, G, eps2, sc, acc, phi, s);
    else
      launch<R, true, false>(pos, mass, n, S, G, eps2, sc, acc, phi, s);
  } else {
    if (guarded)
      launch<R, false, true>(pos, mass, n, S, G, eps2, sc, acc, phi, s);
    else
      launch<R, false, false>(pos, mass, n, S, G, eps2, sc, acc, phi, s);
  }
}

}  // namespace

// The tile edge of K3, K6 and K7 (pair.cuh:kSymTile); they size scratch as
// nt * nt * T slots with nt = ceil(n / T).
extern "C" int ocn_sym_tile() { return ocn::kSymTile; }

// K2's geometry at N = n, encoded R * 16 + S (csrc/sym_rows.cuh).
extern "C" int ocn_sym_geometry(int n) { return sym_geometry(n); }

// Floats of scratch K2 needs at N = n in geometry geom (0: sym_geometry(n),
// the one ocn_sym_accel takes); -1 for a geometry not compiled.
extern "C" long long ocn_sym_scratch(int n, int geom) {
  const int g = geom == 0 ? sym_geometry(n) : geom;
  if (!rb::geom_ok(g)) return -1;
  const int R = g / 16, S = g % 16;
  const long long nt = tiles(n, R);
  return 4LL * nt * nt * S * R * rb::kThreads;
}

// K2 in geometry geom (0: sym_geometry(n)). pos (n, 3), mass (n,) and acc
// (n, 3) are contiguous f32 on the device; phi (n,) may be null, and then
// no potential is computed; scratch holds ocn_sym_scratch(n, geom) floats.
// Returns cudaGetLastError() after both launches, cudaErrorInvalidValue
// for a geometry not compiled.
extern "C" int ocn_sym_accel_at(const float* pos, const float* mass, int n,
                                float G, float eps2, int guarded, int geom,
                                void* scratch, float* acc, float* phi,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* sc = static_cast<float4*>(scratch);
  const int g = geom == 0 ? sym_geometry(n) : geom;
  if (!rb::geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = g / 16, S = g % 16;
  if (n > 0) {
    switch (R) {
      case 1: launch_r<1>(pos, mass, n, S, G, eps2, guarded, sc, acc, phi, s);
        break;
      case 2: launch_r<2>(pos, mass, n, S, G, eps2, guarded, sc, acc, phi, s);
        break;
      case 4: launch_r<4>(pos, mass, n, S, G, eps2, guarded, sc, acc, phi, s);
        break;
      default:
        launch_r<8>(pos, mass, n, S, G, eps2, guarded, sc, acc, phi, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 in the geometry sym_geometry(n) picks: the entry every caller of the
// port takes.
extern "C" int ocn_sym_accel(const float* pos, const float* mass, int n,
                             float G, float eps2, int guarded, void* scratch,
                             float* acc, float* phi, void* stream) {
  return ocn_sym_accel_at(pos, mass, n, G, eps2, guarded, 0, scratch, acc,
                          phi, stream);
}
