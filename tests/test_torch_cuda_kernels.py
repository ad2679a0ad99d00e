"""The CUDA kernels K1 (rows_accel), K2 (sym_accel), K3 (sym_jerk), K4
(rows_jerk), K5 (rows_jerk_t) and, at the extended (hi/lo) tier, K6
(sym_accel_x), K7 (sym_jerk_x), K8 (rows_accel_x) and K9 (rows_jerk_x)
against their plain PyTorch twins in f64, on the card. Every test here needs an NVIDIA GPU and
nvcc, and skips without them; on the card run

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which that machine does
not have; this file imports no JAX). Sizes cover ragged tiles, both guard
modes and the potential output; tolerances are the JAX package's own
(accel atol 5e-6·max|a|, phi rtol 3e-5), and jerk atol 1e-5·max|j|: the
jerk sums the difference of two terms of one size, so its f32 rounding is
about twice the accel's. K5 at 32,768 sources is held to 2e-5 of max|a|
and max|j|, the bound the port sets past 16,384 sources (PERF.md §2); it is
also bitwise repeatable and gives a row the same bits whatever other rows
share the launch. K6-K9 are held to the f64 evaluation of the same (hi,
lo) planes at the same tolerances (their f32 sums are of the same length),
and on the close-pair case to the f64 oracle of the unsplit positions at
the tier's bounds (2e-5 of max|a|, 5e-5 of max|j|) where the f32 kernels
err past 1e-3; K6, K7 and K9 repeat bitwise and K9 gives a row the same
bits whatever other rows share the launch. K10 (rows_accel_df) and K11
(rows_jerk_df), the two-float tier, are held to the f64 evaluation of their
planes at 1e-9 of max|a| and 1e-8 of max|j| (the tier's ~48-bit arithmetic
leaves ~1e-11; the bounds leave room for cancellation in a row's sum),
repeat bitwise, and on the close-pair case stay inside 1e-9 / 1e-8 of the
f64 oracle; the device's two_sum and two_prod are exact and its df_rsqrt is
inside 1e-13. The ragged sizes 1,000 and 10,650 (the binaries config's N)
run through K6, K7, K9, K10 and K11; K2 runs at 8,192 and 10,650 too, and
K2, K12, K6 and K15 in each of their tile geometries (csrc/sym_rows.cuh)
on ragged sizes, where a NaN-filled scratch gives the same bits. K12 (cross_accel,
with and without the potential) and K13 (cross_jerk), the disjoint-set
kernels of the
chunked self-interaction, are held to their f64 twins on ragged set pairs
at the same tolerances and repeat bitwise, also on a reused scratch buffer;
the chunked route itself runs on the card with STREAM_N lowered. K14 (K5's
compensated variant, rows past STREAM_N sources) is held to 2e-5 of max at
up to 300,000 sources and 70,000 rows, repeats bitwise and gives a row the
same bits whatever other rows share the launch. The extended tier's K15
(cross_accel_x, with and without the raw potential), K16 (cross_jerk_x) and
K17 (K9's compensated variant, rows past STREAM_N sources or RT_MAX_ROWS
rows) are held to their f64 twins the same way; the extended chunked route
runs on the card with STREAM_N lowered, and on the close-pair case with
every pair split across chunks it stays inside the tier's bounds where the
f32 chunked route errs past 1e-3. Escape pruning's K18 (rows_accel_t, and
its compensated form K18<comp>) and K19 (rows_accel_xs) are held to their
f64 twins the same way, repeat bitwise and give a row the same bits
whatever other rows share the launch; past STREAM_N their Kahan steps are
shown to work: K18<comp> and K19 err at most 5e-7 of max|a| and at most a
third of what their layout errs without them. The sharded ring's K20
(ring_accel, with and without the potential) and K21 (ring_jerk) are held
to their f64 twins at the first ring step (a store, the compensations
zeroed) and at a step onto non-zero incoming sums (sum - comp grows by the
f64 step), at the same tolerances, and repeat bitwise; every mode of the
sharded force on 4 shards of the card matches the unsharded ForceModel to
2e-5 and repeats bitwise; the overlapped ring equals its serial schedule
bitwise, and d = 1 is one launch. K13 and K16 run in each of their compiled
tile geometries (csrc/jerk_rows.cuh) on ragged sets, where a NaN-filled
scratch gives the same bits. At eps = 0 a pair 1e-20 apart (u below the
least normal f32) adds nothing in every guarded kernel K1-K21, as in its
f32 twin (ROADMAP C6). K22 (knn_density), the CH85 k-th-nearest-neighbour
sweep of the diagnostics row, is held to its plain twin run on the same
card tensors: on integer lattices (exact d², masses in eighths: ties,
coincident stars, fewer than k distinct distances, ragged source tiles)
its rk2 and mnb, and local_density's rho with and without the r_min floor,
are bitwise the twin's; on Plummer spheres of 1,000, 10,650, 32,768,
65,536 and 131,072 stars (strided by 2) rk2 is bitwise, mnb, r_core and
rho_core within 1e-6; two launches are bitwise equal, and a row launches
K22 once and never the twin. K23 (phi_f64), the f64 row's pair potential,
is tested in tests/test_torch_phi_f64.py; here it is one of the kernels
every wrapper launches once.
"""
import numpy as np
import pytest
import torch

from oc_nbody_tpu_torch import diagnostics as tdiag
from oc_nbody_tpu_torch.models.plummer import plummer
from oc_nbody_tpu_torch.ops import cuda_df, cuda_knn, cuda_phi64, cuda_ring
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import df32, gravity
from oc_nbody_tpu_torch.ops.gravity import prepare_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card with "
                    "-m cuda --noconftest)")
    return torch.device("cuda")


def _cluster(n, seed, device):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(size=(n, 3))).to(device)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(device)
    return prepare_f32(pos, mass)


def _moving_cluster(n, seed, device):
    """Centred f32 (pos, mass, vel) with virial-scale velocities."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(size=(n, 3))).to(device)
    vel = torch.from_numpy(rng.normal(size=(n, 3)) * 0.5).to(device)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(device)
    return prepare_f32(pos, mass, vel=vel)


def _check_jerk(out, ref):
    for got, want, tol in zip(out, ref, (5e-6, 1e-5)):
        assert got.dtype == torch.float32
        err = float((got.double() - want).abs().max())
        assert err <= tol * float(want.abs().max())


def _check(out, ref, with_phi):
    acc, ref_acc = (out[0], ref[0]) if with_phi else (out, ref)
    assert acc.dtype == torch.float32
    err = float((acc.double() - ref_acc).abs().max())
    assert err <= 5e-6 * float(ref_acc.abs().max())
    if with_phi:
        torch.testing.assert_close(out[1].double(), ref[1], rtol=3e-5,
                                   atol=0.0)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nr,ns", [(1, 1), (127, 129), (1000, 1000),
                                   (300, 4097)])
def test_rows_kernel_matches_plain(cuda, nr, ns, with_phi, eps):
    src, mass = _cluster(ns, ns, cuda)
    rows = (src[:nr] + 0.01).contiguous() if nr != ns else src
    out = cg.rows_kernel(rows, src, mass, eps, 1.3, with_phi=with_phi,
                         guarded=eps == 0.0)
    ref = cg.rows_plain(rows, src, mass, eps, 1.3, with_phi=with_phi,
                        dtype=torch.float64)
    _check(out, ref, with_phi)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("n", [1, 100, 127, 128, 129, 300, 1000, 1025, 8191,
                               8192, 10650])
def test_sym_kernel_matches_plain_and_repeats_bitwise(cuda, n, with_phi,
                                                      eps):
    pos, mass = _cluster(n, n, cuda)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.sym_kernel(pos, mass, eps, 1.3, **kw)
    again = cg.sym_kernel(pos, mass, eps, 1.3, **kw)
    ref = cg.sym_plain(pos, mass, eps, 1.3, with_phi=with_phi,
                       dtype=torch.float64)
    _check(out, ref, with_phi)
    pairs = zip(out, again) if with_phi else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs)


def _nan_scratch(floats, device):
    return torch.full((floats,), float("nan"), dtype=torch.float32,
                      device=device)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("n", [1000, 3001])
def test_sym_kernel_every_geometry(cuda, n, geometry, with_phi, eps):
    """K2 in each compiled (R rows a thread, S column parts) on ragged N
    against its f64 twin; a launch on a NaN-filled scratch gives the same
    bits, so every slot the reduce reads was written."""
    pos, mass = _cluster(n, n + 7, cuda)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0, geometry=geometry)
    out = cg.sym_kernel(pos, mass, eps, 1.3, **kw)
    nan = _nan_scratch(cg.sym_scratch_floats(n, "sym", geometry), cuda)
    again = cg.sym_kernel(pos, mass, eps, 1.3, scratch=nan, **kw)
    ref = cg.sym_plain(pos, mass, eps, 1.3, with_phi=with_phi,
                       dtype=torch.float64)
    _check(out, ref, with_phi)
    pairs = zip(out, again) if with_phi else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("nr,ns", [(1, 1), (127, 129), (1000, 1000),
                                   (300, 4097)])
def test_rows_jerk_kernel_matches_plain(cuda, nr, ns, eps):
    src, mass, svel = _moving_cluster(ns, ns, cuda)
    rows = (src[:nr] + 0.01).contiguous() if nr != ns else src
    vrows = (svel[:nr] - 0.02).contiguous() if nr != ns else svel
    out = cg.rows_jerk_kernel(rows, vrows, src, svel, mass, eps, 1.3,
                              guarded=eps == 0.0)
    ref = cg.rows_jerk_plain(rows, vrows, src, svel, mass, eps, 1.3,
                             dtype=torch.float64)
    _check_jerk(out, ref)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 1000, 8191])
def test_sym_jerk_kernel_matches_plain_and_repeats_bitwise(cuda, n, eps):
    pos, mass, vel = _moving_cluster(n, n, cuda)
    out = cg.sym_jerk_kernel(pos, vel, mass, eps, 1.3, guarded=eps == 0.0)
    again = cg.sym_jerk_kernel(pos, vel, mass, eps, 1.3, guarded=eps == 0.0)
    ref = cg.sym_jerk_plain(pos, vel, mass, eps, 1.3, dtype=torch.float64)
    _check_jerk(out, ref)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_guarded_self_pair_adds_no_jerk(cuda):
    """eps = 0, two particles at one point: inv = 0 gives zero accel and
    zero jerk, not NaN, in the three jerk kernels."""
    pos = torch.zeros((2, 3), dtype=torch.float32, device=cuda)
    vel = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], dtype=torch.float32,
                       device=cuda)
    mass = torch.ones(2, dtype=torch.float32, device=cuda)
    for out in (cg.sym_jerk_kernel(pos, vel, mass, 0.0, guarded=True),
                cg.rows_jerk_kernel(pos, vel, pos, vel, mass, 0.0,
                                    guarded=True),
                cg.rows_jerk_t_kernel(pos, vel, pos, vel, mass, 0.0,
                                      guarded=True)):
        assert all(bool((t == 0).all()) for t in out)


def test_wrappers_launch_the_kernels_on_cuda(cuda, monkeypatch):
    pos, mass, vel = _moving_cluster(16384, 1, cuda)
    pos64, vel64 = pos.double(), vel.double()
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    ax = cg.accel_x(pos64[:8192], mass[:8192], 1.0 / 64)  # N = SYM_MIN: K6
    cg.accel_potential_x(pos64[:1000], mass[:1000], 1.0 / 64)   # below: K8
    cg.accel_jerk_x(pos64[:8192], vel64[:8192], mass[:8192],
                    1.0 / 64)                             # N = SYM_MIN: K7
    cg.accel_jerk_rows_x(pos64[:64], vel64[:64], pos64, vel64, mass,
                         1.0 / 64)                        # rows: K9
    assert ax.dtype == torch.float64
    acc, phi = cg.accel_potential(pos64[:8192], mass[:8192],
                                  1.0 / 64)             # N = SYM_MIN: K2
    cg.accel(pos64[:1000], mass[:1000], 1.0 / 64)       # N < SYM_MIN: K1
    a, j = cg.accel_jerk(pos64, vel64, mass,
                         1.0 / 64)                      # N = RT_MIN_JERK: K3
    cg.accel_jerk(pos64[:1000], vel64[:1000], mass[:1000],
                  1.0 / 64)                             # below: K4
    cg.accel_jerk_rows(pos[:64], vel[:64], pos, vel, mass,
                       1.0 / 64)                        # rows: K5
    cuda_df.accel_df(pos64[:1000], mass[:1000], 1.0 / 64)         # K10
    cuda_df.accel_jerk_df(pos64[:1000], vel64[:1000], mass[:1000],
                          1.0 / 64)                               # K11
    cg.accel_cross_pair(pos[:100], pos[100:300], mass[:100], mass[100:300],
                        1.0 / 64)                       # disjoint sets: K12
    cg.accel_jerk_cross_pair(pos[:100], vel[:100], pos[100:300],
                             vel[100:300], mass[:100], mass[100:300],
                             1.0 / 64)                  # K13
    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos64[:300], mass[:300], 1.0,
                                             vel=vel64[:300])
    cg.accel_cross_pair_x_hilo(hi[:100], lo[:100], hi[100:], lo[100:],
                               gm[:100], gm[100:], 1.0 / 64)      # K15
    cg.accel_jerk_cross_pair_x_hilo(hi[:100], lo[:100], vhi[:100], vlo[:100],
                                    hi[100:], lo[100:], vhi[100:], vlo[100:],
                                    gm[:100], gm[100:], 1.0 / 64)  # K16
    monkeypatch.setattr(cg, "RT_MIN_ACCEL", 16384)
    cg.accel_rows(pos[:64], pos, mass, 1.0 / 64)        # rows: K18
    monkeypatch.setattr(cg, "STREAM_N", 8191)
    cg.accel_jerk_rows(pos[:64], vel[:64], pos[:8192], vel[:8192],
                       mass[:8192], 1.0 / 64)           # past STREAM_N: K14
    cg.accel_jerk_rows_x(pos64[:64], vel64[:64], pos64[:8192], vel64[:8192],
                         mass[:8192], 1.0 / 64)         # past STREAM_N: K17
    cg.accel_potential_rows(pos[:64], pos[:8192], mass[:8192],
                            1.0 / 64)                   # K18<comp>
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 63)
    cg.accel_rows_x_hilo(hi[:64], lo[:64], hi, lo, gm,
                         1.0 / 64)                      # past it: K19
    cuda_ring.accel_ring([pos[:64]], [mass[:64]], 1.0 / 64)   # one shard: K20
    cuda_ring.accel_potential_ring([pos[:64]], [mass[:64]],
                                   1.0 / 64)            # K20<phi>
    cuda_ring.accel_jerk_ring([pos[:64]], [vel[:64]], [mass[:64]],
                              1.0 / 64)                 # K21
    cuda_knn.knn_density(pos[:1000], pos[:1000], mass[:1000], 6)   # K22
    cuda_phi64.potential(pos64[:1000], mass[:1000], 1.0 / 64)      # K23
    torch.cuda.synchronize()
    assert acc.dtype == phi.dtype == a.dtype == j.dtype == torch.float64
    assert cg.LAUNCHES == {key: launches[key] + 1 for key in launches}
    assert cg.PLAIN_CALLS == plain


def test_kernel_launchers_check_their_input(cuda):
    pos, mass = _cluster(64, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        cg.rows_kernel(pos.double(), pos, mass, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        cg.sym_kernel(pos.t().contiguous().t(), mass, 0.1)
    with pytest.raises(ValueError, match="shape"):
        cg.rows_kernel(pos, pos, mass[:10], 0.1)
    with pytest.raises(TypeError, match="float32"):
        cg.sym_jerk_kernel(pos, pos.double(), mass, 0.1)
    with pytest.raises(ValueError, match="shape"):
        cg.rows_jerk_kernel(pos, pos[:10], pos, pos, mass, 0.1)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("nr,ns", [(1, 1), (37, 300), (200, 16385),
                                   (1, 32768), (64, 32768), (1024, 32768),
                                   (8192, 32768), (32768, 32768)])
def test_rows_jerk_t_kernel_matches_plain(cuda, nr, ns, eps):
    src, mass, svel = _moving_cluster(ns, ns + 7, cuda)
    rows = (src[:nr] + 0.01).contiguous() if nr != ns else src
    vrows = (svel[:nr] - 0.02).contiguous() if nr != ns else svel
    out = cg.rows_jerk_t_kernel(rows, vrows, src, svel, mass, eps, 1.3,
                                guarded=eps == 0.0)
    again = cg.rows_jerk_t_kernel(rows, vrows, src, svel, mass, eps, 1.3,
                                  guarded=eps == 0.0)
    ref = cg.rows_jerk_t_plain(rows, vrows, src, svel, mass, eps, 1.3,
                               dtype=torch.float64)
    tol = (2e-5, 2e-5) if ns > 16384 else (5e-6, 1e-5)
    for got, want, t in zip(out, ref, tol):
        assert got.dtype == torch.float32
        err = float((got.double() - want).abs().max())
        assert err <= t * float(want.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("guarded", [True, False])
def test_rows_jerk_t_rows_are_independent_of_the_launch(cuda, guarded):
    """A row's result is bitwise the same alone, in a subset, or among all
    rows: what makes compacted and masked block steps agree on the card."""
    src, mass, svel = _moving_cluster(32768, 5, cuda)
    eps = 0.0 if guarded else 1.0 / 256
    full = cg.rows_jerk_t_kernel(src, svel, src, svel, mass, eps,
                                 guarded=guarded)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for k in (1, 5, 64, 4095):
        rows = torch.randperm(32768, generator=gen)[:k].to(cuda)
        sub = cg.rows_jerk_t_kernel(src[rows].contiguous(),
                                    svel[rows].contiguous(), src, svel, mass,
                                    eps, guarded=guarded)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nA,nB", [(1, 1), (1, 300), (127, 129), (1000, 300),
                                   (4097, 2000), (1025, 5000), (9000, 3001)])
def test_cross_kernel_matches_plain_and_repeats_bitwise(cuda, nA, nB,
                                                        with_phi, eps):
    """K12 (K12<phi>) on disjoint ragged sets against its f64 twin, both
    sets' outputs; two launches, and a launch on a larger reused scratch
    buffer, bitwise equal."""
    pos, mass = _cluster(nA + nB, nA + nB, cuda)
    pA, pB = pos[:nA].contiguous(), pos[nA:].contiguous()
    mA, mB = mass[:nA].contiguous(), mass[nA:].contiguous()
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.cross_kernel(pA, pB, mA, mB, eps, 1.3, **kw)
    again = cg.cross_kernel(pA, pB, mA, mB, eps, 1.3, **kw)
    big = torch.empty((cg.cross_scratch_floats(nA, nB) + 4096,),
                      dtype=torch.float32, device=cuda)
    reused = cg.cross_kernel(pA, pB, mA, mB, eps, 1.3, scratch=big, **kw)
    ref = cg.cross_plain(pA, pB, mA, mB, eps, 1.3, with_phi=with_phi,
                         dtype=torch.float64)
    half = len(out) // 2
    _check(out[:half] if with_phi else out[0], ref[:half] if with_phi
           else ref[0], with_phi)
    _check(out[half:] if with_phi else out[1], ref[half:] if with_phi
           else ref[1], with_phi)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(torch.equal(a, b) for a, b in zip(out, reused))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("nA,nB", [(1, 300), (1000, 3001), (2900, 700)])
def test_cross_kernel_every_geometry(cuda, nA, nB, geometry, with_phi, eps):
    """K12 in each compiled (R rows a thread, S column parts) on ragged sets
    against its f64 twin, both sets' outputs; a launch on a NaN-filled
    scratch gives the same bits."""
    pos, mass = _cluster(nA + nB, nA + nB + 5, cuda)
    pA, pB = pos[:nA].contiguous(), pos[nA:].contiguous()
    mA, mB = mass[:nA].contiguous(), mass[nA:].contiguous()
    kw = dict(with_phi=with_phi, guarded=eps == 0.0, geometry=geometry)
    out = cg.cross_kernel(pA, pB, mA, mB, eps, 1.3, **kw)
    nan = _nan_scratch(cg.cross_scratch_floats(nA, nB, "cross", geometry),
                       cuda)
    again = cg.cross_kernel(pA, pB, mA, mB, eps, 1.3, scratch=nan, **kw)
    ref = cg.cross_plain(pA, pB, mA, mB, eps, 1.3, with_phi=with_phi,
                         dtype=torch.float64)
    half = len(out) // 2
    _check(out[:half] if with_phi else out[0], ref[:half] if with_phi
           else ref[0], with_phi)
    _check(out[half:] if with_phi else out[1], ref[half:] if with_phi
           else ref[1], with_phi)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_geometry_follows_the_sizes(cuda):
    """K2 and K12 pick the most rows a thread that still fills the card
    (csrc/sym_rows.cuh: 1,024 blocks), from the sizes alone; K6 and K15 by
    the same rule, K13 and K16 too."""
    assert cg.sym_geometry(1000) == (1, 1)
    assert cg.sym_geometry(8192) == (2, 2)
    assert cg.sym_geometry(32768) == (8, 2)
    assert cg.sym_geometry(65536) == (8, 1)
    assert cg.cross_geometry(131072, 131072) == (8, 1)
    assert cg.cross_geometry(16384, 16384) == (8, 4)
    # K6 and K15 (the Ext tier of csrc/sym_rows.cuh) at c5x's N, the
    # extended route's chunk and its ragged pair at 1M, and small sizes
    for n in (1000, 8192, 32768, 65536, 98304, 131072):
        assert cg.sym_geometry(n, "sym_x") == cg.sym_geometry(n)
    assert cg.sym_geometry(131072, "sym_x") == (8, 1)
    assert cg.sym_geometry(98304, "sym_x") == (8, 1)
    assert cg.cross_geometry(98304, 98304, "cross_x") == (8, 1)
    assert cg.cross_geometry(98304, 65536, "cross_x") == (8, 1)
    assert cg.cross_geometry(16384, 16384, "cross_x") == (8, 4)
    assert cg.cross_geometry(1000, 300, "cross_x") == (1, 1)
    # K13 and K16 (csrc/jerk_rows.cuh) by the same rule, at their chunk
    # pairs at 1M and the ragged ones
    for key in ("cross_jerk", "cross_jerk_x"):
        assert cg.cross_geometry(98304, 98304, key) == (8, 1)
        assert cg.cross_geometry(98304, 65536, key) == (8, 1)
        assert cg.cross_geometry(73728, 73728, key) == (8, 1)
        assert cg.cross_geometry(73728, 16384, key) == (8, 1)
        assert cg.cross_geometry(1000, 300, key) == (1, 1)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("nA,nB", [(1, 1), (1, 300), (127, 129), (1000, 300),
                                   (4097, 2000)])
def test_cross_jerk_kernel_matches_plain_and_repeats_bitwise(cuda, nA, nB,
                                                             eps):
    """K13 on disjoint ragged sets against its f64 twin; two launches
    bitwise equal."""
    pos, mass, vel = _moving_cluster(nA + nB, nA + nB + 1, cuda)
    args = (pos[:nA].contiguous(), vel[:nA].contiguous(),
            pos[nA:].contiguous(), vel[nA:].contiguous(),
            mass[:nA].contiguous(), mass[nA:].contiguous())
    out = cg.cross_jerk_kernel(*args, eps, 1.3, guarded=eps == 0.0)
    again = cg.cross_jerk_kernel(*args, eps, 1.3, guarded=eps == 0.0)
    ref = cg.cross_jerk_plain(*args, eps, 1.3, dtype=torch.float64)
    _check_jerk(out[:2], ref[:2])
    _check_jerk(out[2:], ref[2:])
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("nA,nB", [(1, 300), (1000, 3001), (2900, 700),
                                   (1025, 16500)])
def test_cross_jerk_kernel_every_geometry(cuda, nA, nB, geometry, eps):
    """K13 in each compiled (R rows a thread, S column parts) on ragged sets
    against its f64 twin, both sets' outputs (5e-6 of max|a|, 1e-5 of
    max|j|; 2e-5 past 16,384 sources); a launch on a NaN-filled scratch
    gives the same bits, so every slot the reduce reads was written."""
    pos, mass, vel = _moving_cluster(nA + nB, nA + nB + 9, cuda)
    args = (pos[:nA].contiguous(), vel[:nA].contiguous(),
            pos[nA:].contiguous(), vel[nA:].contiguous(),
            mass[:nA].contiguous(), mass[nA:].contiguous())
    kw = dict(guarded=eps == 0.0, geometry=geometry)
    out = cg.cross_jerk_kernel(*args, eps, 1.3, **kw)
    nan = _nan_scratch(cg.cross_scratch_floats(nA, nB, "cross_jerk",
                                               geometry), cuda)
    again = cg.cross_jerk_kernel(*args, eps, 1.3, scratch=nan, **kw)
    ref = cg.cross_jerk_plain(*args, eps, 1.3, dtype=torch.float64)
    tol = (2e-5, 2e-5) if max(nA, nB) > 16384 else (5e-6, 1e-5)
    for got, want in ((out[:2], ref[:2]), (out[2:], ref[2:])):
        for g, w, t in zip(got, want, tol):
            assert g.dtype == torch.float32
            assert float((g.double() - w).abs().max()) <= t * float(
                w.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("jerk", [False, True])
def test_chunked_self_interaction_on_cuda(cuda, monkeypatch, jerk):
    """The chunked route on the card at N = 3,000 with STREAM_N lowered and
    chunks of 1,024 (1,024, 1,024 and 952): K2 (K3) three times and K12
    (K13) three times per evaluation, no plain twin; within the f32 bounds
    of the f64 oracle and bitwise repeatable."""
    monkeypatch.setattr(cg, "STREAM_N", 2048)
    monkeypatch.setattr(cg, "CHUNK_SYM", 1024)
    monkeypatch.setattr(cg, "CHUNK_SYMJ", 1024)
    pos, mass, vel = _moving_cluster(3000, 4, cuda)
    pos64, vel64 = pos.double(), vel.double()
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    if jerk:
        out = cg.accel_jerk(pos64, vel64, mass, 1.0 / 64, 1.3, False)
        again = cg.accel_jerk(pos64, vel64, mass, 1.0 / 64, 1.3, False)
        ref = gravity.accel_jerk(pos64, vel64, mass, 1.0 / 64, 1.3,
                                 compute_dtype=torch.float64)
        _check_jerk(tuple(t.float() for t in out), ref)
        keys = ("sym_jerk", "cross_jerk")
    else:
        out = cg.accel_potential(pos64, mass, 1.0 / 64, 1.3, False)
        again = cg.accel_potential(pos64, mass, 1.0 / 64, 1.3, False)
        ref = gravity.accel_potential(pos64, mass, 1.0 / 64, 1.3,
                                      compute_dtype=torch.float64)
        _check(tuple(t.float() for t in out), ref, True)
        keys = ("sym", "cross")
    torch.cuda.synchronize()
    assert all(cg.LAUNCHES[k] == launches[k] + 6 for k in keys)
    assert cg.PLAIN_CALLS == plain
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("nr,ns", [(1, 300), (37, 300), (1000, 40000),
                                   (64, 300000), (70000, 300000)])
def test_rows_jerk_stream_kernel_matches_plain(cuda, nr, ns, eps):
    """K14 (K5 with Kahan steps across stages and chunks) against its f64
    twin, 2e-5 of max past 16,384 sources; row counts past RT_MAX_ROWS;
    two launches bitwise equal."""
    src, mass, svel = _moving_cluster(ns, ns + 11, cuda)
    rows = (src[:nr] + 0.01).contiguous()
    vrows = (svel[:nr] - 0.02).contiguous()
    out = cg.rows_jerk_stream_kernel(rows, vrows, src, svel, mass, eps, 1.3,
                                     guarded=eps == 0.0)
    again = cg.rows_jerk_stream_kernel(rows, vrows, src, svel, mass, eps,
                                       1.3, guarded=eps == 0.0)
    ref = cg.rows_jerk_stream_plain(rows, vrows, src, svel, mass, eps, 1.3,
                                    dtype=torch.float64, chunk=256)
    tol = (2e-5, 2e-5) if ns > 16384 else (5e-6, 1e-5)
    for got, want, t in zip(out, ref, tol):
        assert got.dtype == torch.float32
        err = float((got.double() - want).abs().max())
        assert err <= t * float(want.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("guarded", [True, False])
def test_rows_jerk_stream_rows_are_independent_of_the_launch(cuda, guarded):
    """K14 gives a row the same bits alone, in a subset, or among all
    300,000 rows."""
    src, mass, svel = _moving_cluster(300000, 6, cuda)
    eps = 0.0 if guarded else 1.0 / 256
    full = cg.rows_jerk_stream_kernel(src, svel, src, svel, mass, eps,
                                      guarded=guarded)
    gen = torch.Generator(device="cpu").manual_seed(4)
    for k in (1, 64, 4095):
        rows = torch.randperm(300000, generator=gen)[:k].to(cuda)
        sub = cg.rows_jerk_stream_kernel(src[rows].contiguous(),
                                         svel[rows].contiguous(), src, svel,
                                         mass, eps, guarded=guarded)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


def test_rows_dispatch_launches_k5_on_cuda(cuda):
    """accel_jerk_rows: K5 from RT_MIN_JERK sources up to RT_MAX_ROWS rows,
    K4 below RT_MIN_JERK sources."""
    src, mass, svel = _moving_cluster(16384, 9, cuda)
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    cg.accel_jerk_rows(src[:64], svel[:64], src, svel, mass, 1.0 / 256)
    cg.accel_jerk_rows(src[:64], svel[:64], src[:16383].contiguous(),
                       svel[:16383].contiguous(), mass[:16383].contiguous(),
                       1.0 / 256)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["rows_jerk_t"] == launches["rows_jerk_t"] + 1
    assert cg.LAUNCHES["rows_jerk"] == launches["rows_jerk"] + 1
    assert cg.PLAIN_CALLS == plain


def _block_run(cuda, n, n_micro, eager=False, over=(), **kw):
    """c4's scene (Milky Way, eccentric inclined orbit) at N = n on the
    card, n_micro block micro-steps from init; ``eager`` without the CUDA
    graphs; ``over`` more config overrides."""
    import os
    from oc_nbody_tpu_torch.config import apply_overrides, load_config
    from oc_nbody_tpu_torch.integrators.block import BlockHermite
    from oc_nbody_tpu_torch.scene import build_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c4_block_32k_eccentric.toml")
    cfg = apply_overrides(load_config(path), [f"ic.n={n}", *over])
    scene = build_scene(cfg, cuda)
    ic = cfg.integrator
    stepper = BlockHermite(force=scene.force, eta=ic.eta,
                           eta_init=ic.eta_init, dt_max=ic.dt_max,
                           n_levels=ic.n_levels, **kw)
    if eager:
        object.__setattr__(stepper, "_use_graphs", lambda carry: False)
    return stepper.advance(stepper.init(scene.state), n_micro)


def _carry_fields(c):
    return (c.state.pos, c.state.vel, c.acc, c.jerk, c.a_ext, c.j_ext,
            c.t_i, c.dt_i)


@pytest.mark.parametrize("n", [4096, 16384])
def test_block_graphs_compaction_and_masking_agree_bitwise(cuda, n):
    """Block micro-steps on the card (K4 below 16,384 sources, K5 at it):
    the CUDA-graph replay equals the eager micro-step, and the compacted
    active rows equal the masked full-row evaluation, bit for bit."""
    eager = _block_run(cuda, n, 24, eager=True)
    graphs = _block_run(cuda, n, 24)
    masked = _block_run(cuda, n, 24, n_buckets=0)
    for other in (graphs, masked):
        assert other.n_steps == eager.n_steps == 24
        assert other.n_active_sum == eager.n_active_sum
        assert other.state.time == eager.state.time
        for a, b in zip(_carry_fields(other), _carry_fields(eager)):
            assert torch.equal(a, b)


# ---- the extended (hi/lo) tier: K6-K9 --------------------------------------

def _planes(n, seed, device, vel=True):
    """(hi, lo, gm[, vhi, vlo]) of a cluster 8 kpc from the origin."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(size=(n, 3)) + [8000.0, 0.0, 3.0])
    v = torch.from_numpy(rng.normal(size=(n, 3)) * 0.5 + [0.0, 220.0, 0.0])
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n)
    out = gravity.prepare_x(pos.to(device), mass.to(device), 1.3,
                            vel=v.to(device) if vel else None)
    return out


def _check_x(out, ref, tol=(5e-6, 1e-5), phi=False):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for k, (got, want) in enumerate(zip(out, ref)):
        assert got.dtype == torch.float32 and want.dtype == torch.float64
        if phi and k == 1:
            torch.testing.assert_close(got.double(), want, rtol=3e-5,
                                       atol=0.0)
            continue
        err = float((got.double() - want).abs().max())
        assert err <= tol[k] * float(want.abs().max())


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nr,ns", [(1, 1), (127, 129), (1000, 1000),
                                   (300, 4097)])
def test_rows_x_kernel_matches_plain(cuda, nr, ns, with_phi, eps):
    hi, lo, gm = _planes(ns, ns, cuda, vel=False)
    rows = (hi[:nr].contiguous(), lo[:nr].contiguous())
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.rows_x_kernel(*rows, hi, lo, gm, eps, **kw)
    ref = cg.rows_x_plain(*rows, hi, lo, gm, eps, dtype=torch.float64, **kw)
    _check_x(out, ref, phi=with_phi)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 1000, 8191])
def test_sym_x_kernel_matches_plain_and_repeats_bitwise(cuda, n, with_phi,
                                                        eps):
    hi, lo, gm = _planes(n, n, cuda, vel=False)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.sym_x_kernel(hi, lo, gm, eps, **kw)
    again = cg.sym_x_kernel(hi, lo, gm, eps, **kw)
    ref = cg.sym_x_plain(hi, lo, gm, eps, dtype=torch.float64, **kw)
    _check_x(out, ref, phi=with_phi)
    pairs = zip(out, again) if with_phi else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("n", [1000, 3001])
def test_sym_x_kernel_every_geometry(cuda, n, geometry, with_phi, eps):
    """K6 in each compiled (R rows a thread, S column parts) on ragged N
    against the f64 evaluation of its planes, with and without the raw
    potential; a launch on a NaN-filled scratch gives the same bits, so
    every slot the reduce reads was written."""
    hi, lo, gm = _planes(n, n + 7, cuda, vel=False)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0, geometry=geometry)
    out = cg.sym_x_kernel(hi, lo, gm, eps, **kw)
    nan = _nan_scratch(cg.sym_scratch_floats(n, "sym_x", geometry), cuda)
    again = cg.sym_x_kernel(hi, lo, gm, eps, scratch=nan, **kw)
    ref = cg.sym_x_plain(hi, lo, gm, eps, with_phi=with_phi,
                         dtype=torch.float64, guarded=eps == 0.0)
    _check_x(out, ref, phi=with_phi)
    pairs = zip(out, again) if with_phi else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 1000, 8191])
def test_sym_jerk_x_kernel_matches_plain_and_repeats_bitwise(cuda, n, eps):
    hi, lo, gm, vhi, vlo = _planes(n, n, cuda)
    guarded = eps == 0.0
    out = cg.sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps, guarded=guarded)
    again = cg.sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps, guarded=guarded)
    ref = cg.sym_jerk_x_plain(hi, lo, vhi, vlo, gm, eps,
                              dtype=torch.float64, guarded=guarded)
    _check_x(out, ref)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("nr,ns", [(1, 1), (37, 300), (1000, 1000),
                                   (200, 16385), (1, 32768), (64, 32768),
                                   (8192, 32768)])
def test_rows_jerk_x_kernel_matches_plain_and_repeats_bitwise(cuda, nr, ns,
                                                              eps):
    hi, lo, gm, vhi, vlo = _planes(ns, ns + 7, cuda)
    rows = tuple(p[:nr].contiguous() for p in (hi, lo, vhi, vlo))
    guarded = eps == 0.0
    out = cg.rows_jerk_x_kernel(*rows, hi, lo, vhi, vlo, gm, eps,
                                guarded=guarded)
    again = cg.rows_jerk_x_kernel(*rows, hi, lo, vhi, vlo, gm, eps,
                                  guarded=guarded)
    ref = cg.rows_jerk_x_plain(*rows, hi, lo, vhi, vlo, gm, eps,
                               dtype=torch.float64, guarded=guarded)
    _check_x(out, ref, tol=(2e-5, 2e-5) if ns > 16384 else (5e-6, 1e-5))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("guarded", [True, False])
def test_rows_jerk_x_rows_are_independent_of_the_launch(cuda, guarded):
    hi, lo, gm, vhi, vlo = _planes(32768, 5, cuda)
    eps = 0.0 if guarded else 1.0 / 256
    src = (hi, lo, vhi, vlo)
    full = cg.rows_jerk_x_kernel(*src, *src, gm, eps, guarded=guarded)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for k in (1, 5, 64, 4095):
        rows = torch.randperm(32768, generator=gen)[:k].to(cuda)
        sub = cg.rows_jerk_x_kernel(*(p[rows] for p in src), *src, gm, eps,
                                    guarded=guarded)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


def test_close_pairs_tell_the_tiers_apart_on_the_card(cuda):
    """50 pairs at 1e-5 of the coordinate scale, eps = 1e-4: the f32
    kernels err past 1e-3 of max|a|, the extended kernels stay inside 2e-5
    of max|a| and 5e-5 of max|j| of the f64 oracle of the unsplit state."""
    rng = np.random.default_rng(7)
    n, eps = 600, 1e-4
    pos = rng.normal(size=(n, 3))
    pos[50:100] = pos[:50] + 1e-5 * rng.normal(size=(50, 3))
    pos = torch.from_numpy(pos).to(cuda)
    vel = torch.from_numpy(0.3 * rng.normal(size=(n, 3))).to(cuda)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(cuda)
    a_ref, j_ref = gravity.accel_jerk_direct(pos, vel, mass, eps)

    def rel(got, want):
        return float(torch.linalg.norm(got - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos, mass, 1.0, vel=vel)
    src = (hi, lo, vhi, vlo)
    pos_c, mass_c, vel_c = prepare_f32(pos, mass, vel=vel)
    assert rel(cg.rows_kernel(pos_c, pos_c, mass_c, eps).double(),
               a_ref) > 1e-3
    assert rel(cg.sym_kernel(pos_c, mass_c, eps).double(), a_ref) > 1e-3
    assert rel(cg.rows_jerk_kernel(pos_c, vel_c, pos_c, vel_c, mass_c,
                                   eps)[0].double(), a_ref) > 1e-3
    for acc in (cg.rows_x_kernel(hi, lo, hi, lo, gm, eps),
                cg.sym_x_kernel(hi, lo, gm, eps)):
        assert rel(acc.double(), a_ref) < 2e-5
    for acc, jerk in (cg.rows_jerk_x_kernel(*src, *src, gm, eps),
                      cg.sym_jerk_x_kernel(*src, gm, eps)):
        assert rel(acc.double(), a_ref) < 2e-5
        assert rel(jerk.double(), j_ref) < 5e-5
    # a kernel that dropped lo would be the f32 tier
    zero = torch.zeros_like(lo)
    assert rel(cg.rows_x_kernel(hi, zero, hi, zero, gm, eps).double(),
               a_ref) > 1e-3


def test_guarded_coincident_pair_adds_nothing_at_the_extended_tier(cuda):
    z = torch.zeros((2, 3), dtype=torch.float32, device=cuda)
    vel = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], dtype=torch.float32,
                       device=cuda)
    gm = torch.ones(2, dtype=torch.float32, device=cuda)
    outs = (cg.sym_jerk_x_kernel(z, z, vel, z, gm, 0.0, guarded=True),
            cg.rows_jerk_x_kernel(z, z, vel, z, z, z, vel, z, gm, 0.0,
                                  guarded=True),
            cg.sym_x_kernel(z, z, gm, 0.0, with_phi=True, guarded=True),
            cg.rows_x_kernel(z, z, z, z, gm, 0.0, with_phi=True,
                             guarded=True))
    for out in outs:
        assert all(bool((t == 0).all()) for t in out)


def test_extended_launchers_check_their_input(cuda):
    hi, lo, gm = _planes(64, 2, cuda, vel=False)
    with pytest.raises(TypeError, match="float32"):
        cg.rows_x_kernel(hi.double(), lo, hi, lo, gm, 0.1)
    with pytest.raises(ValueError, match="shape"):
        cg.sym_x_kernel(hi, lo[:10], gm, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        cg.sym_jerk_x_kernel(hi, lo, hi.t().contiguous().t(), lo, gm, 0.1)
    # past STREAM_N sources the rows accel form takes K19 (zero masses: a
    # zero force)
    big = torch.zeros((cg.STREAM_N + 1, 3), dtype=torch.float32, device=cuda)
    launches = cg.LAUNCHES["rows_x_stream"]
    out = cg.accel_rows_x_hilo(hi, lo, big, big, big[:, 0].contiguous(), 0.1)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["rows_x_stream"] == launches + 1
    assert not bool(out.any())


@pytest.mark.parametrize("n", [4096, 16384])
def test_block_graphs_compaction_and_masking_agree_bitwise_extended(cuda, n):
    """The same three-way bitwise agreement of block micro-steps at the
    extended tier (K9 on the active rows, K9 or K7 at init)."""
    over = ["integrator.precision=extended"]
    eager = _block_run(cuda, n, 24, eager=True, over=over)
    graphs = _block_run(cuda, n, 24, over=over)
    masked = _block_run(cuda, n, 24, n_buckets=0, over=over)
    for other in (graphs, masked):
        assert other.n_steps == eager.n_steps == 24
        assert other.n_active_sum == eager.n_active_sum
        assert other.state.time == eager.state.time
        for a, b in zip(_carry_fields(other), _carry_fields(eager)):
            assert torch.equal(a, b)


# ---- the extended tier past one resident set: K15-K17 ----------------------

def _split_sets(nA, n, seed, device, vel=True):
    """Planes of A (the first nA) and B (the rest) of one cluster, split
    under ONE centring: (hiA, loA[, vhiA, vloA]), (hiB, ...), gmA, gmB."""
    planes = _planes(n, seed, device, vel=vel)
    hi, lo, gm = planes[:3]
    sets = (hi, lo, *planes[3:])
    return (tuple(p[:nA].contiguous() for p in sets),
            tuple(p[nA:].contiguous() for p in sets),
            gm[:nA].contiguous(), gm[nA:].contiguous())


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nA,nB", [(1, 1), (1, 300), (127, 129), (1000, 300),
                                   (4097, 2000)])
def test_cross_x_kernel_matches_plain_and_repeats_bitwise(cuda, nA, nB,
                                                          with_phi, eps):
    """K15 (K15<phi>) on disjoint ragged sets against its f64 twin, both
    sets' outputs; two launches, and a launch on a larger reused scratch
    buffer, bitwise equal."""
    A, B, gA, gB = _split_sets(nA, nA + nB, nA + nB + 2, cuda, vel=False)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.cross_x_kernel(*A, *B, gA, gB, eps, **kw)
    again = cg.cross_x_kernel(*A, *B, gA, gB, eps, **kw)
    big = torch.empty((cg.cross_scratch_floats(nA + 128, nB + 128,
                                               "cross_x"),),
                      dtype=torch.float32, device=cuda)
    reused = cg.cross_x_kernel(*A, *B, gA, gB, eps, scratch=big, **kw)
    ref = cg.cross_x_plain(*A, *B, gA, gB, eps, dtype=torch.float64, **kw)
    half = len(out) // 2
    _check_x(out[:half], ref[:half], phi=with_phi)
    _check_x(out[half:], ref[half:], phi=with_phi)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(torch.equal(a, b) for a, b in zip(out, reused))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("nA,nB", [(1, 300), (1000, 3001), (2900, 700)])
def test_cross_x_kernel_every_geometry(cuda, nA, nB, geometry, with_phi,
                                       eps):
    """K15 in each compiled (R rows a thread, S column parts) on ragged sets
    against the f64 evaluation of the same planes, both sets' outputs, with
    and without the raw potential; a launch on a NaN-filled scratch gives
    the same bits, so every slot the reduce reads was written."""
    A, B, gA, gB = _split_sets(nA, nA + nB, nA + nB + 13, cuda, vel=False)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0, geometry=geometry)
    out = cg.cross_x_kernel(*A, *B, gA, gB, eps, **kw)
    nan = _nan_scratch(cg.cross_scratch_floats(nA, nB, "cross_x", geometry),
                       cuda)
    again = cg.cross_x_kernel(*A, *B, gA, gB, eps, scratch=nan, **kw)
    ref = cg.cross_x_plain(*A, *B, gA, gB, eps, with_phi=with_phi,
                           dtype=torch.float64, guarded=eps == 0.0)
    half = len(out) // 2
    _check_x(out[:half], ref[:half], phi=with_phi)
    _check_x(out[half:], ref[half:], phi=with_phi)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("nA,nB", [(1, 1), (1, 300), (127, 129), (1000, 300),
                                   (4097, 2000)])
def test_cross_jerk_x_kernel_matches_plain_and_repeats_bitwise(cuda, nA, nB,
                                                               eps):
    """K16 on disjoint ragged sets against its f64 twin; two launches
    bitwise equal."""
    A, B, gA, gB = _split_sets(nA, nA + nB, nA + nB + 3, cuda)
    guarded = eps == 0.0
    out = cg.cross_jerk_x_kernel(*A, *B, gA, gB, eps, guarded=guarded)
    again = cg.cross_jerk_x_kernel(*A, *B, gA, gB, eps, guarded=guarded)
    ref = cg.cross_jerk_x_plain(*A, *B, gA, gB, eps, dtype=torch.float64,
                                guarded=guarded)
    _check_x(out[:2], ref[:2])
    _check_x(out[2:], ref[2:])
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("geometry", cg.GEOMETRIES)
@pytest.mark.parametrize("nA,nB", [(1, 300), (1000, 3001), (2900, 700),
                                   (1025, 16500)])
def test_cross_jerk_x_kernel_every_geometry(cuda, nA, nB, geometry, eps):
    """K16 in each compiled (R rows a thread, S column parts) on ragged sets
    against the f64 evaluation of the same planes, both sets' outputs (5e-6
    of max|a|, 1e-5 of max|j|; 2e-5 past 16,384 sources); a launch on a
    NaN-filled scratch gives the same bits."""
    A, B, gA, gB = _split_sets(nA, nA + nB, nA + nB + 11, cuda)
    kw = dict(guarded=eps == 0.0, geometry=geometry)
    out = cg.cross_jerk_x_kernel(*A, *B, gA, gB, eps, **kw)
    nan = _nan_scratch(cg.cross_scratch_floats(nA, nB, "cross_jerk_x",
                                               geometry), cuda)
    again = cg.cross_jerk_x_kernel(*A, *B, gA, gB, eps, scratch=nan, **kw)
    ref = cg.cross_jerk_x_plain(*A, *B, gA, gB, eps, dtype=torch.float64,
                                guarded=eps == 0.0)
    tol = (2e-5, 2e-5) if max(nA, nB) > 16384 else (5e-6, 1e-5)
    _check_x(out[:2], ref[:2], tol)
    _check_x(out[2:], ref[2:], tol)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("jerk", [False, True])
def test_chunked_self_interaction_x_on_cuda(cuda, monkeypatch, jerk):
    """The extended chunked route on the card at N = 3,000 with STREAM_N
    lowered and chunks of 1,024: K6 (K7) three times and K15 (K16) three
    times per evaluation, no plain twin; within the tier's bounds of the
    f64 oracle (2e-5 of max|a|, 5e-5 of max|j|, phi 5e-6 once self_phi is
    added) and bitwise repeatable."""
    monkeypatch.setattr(cg, "STREAM_N", 2048)
    monkeypatch.setattr(cg, "CHUNK_SYMX", 1024)
    monkeypatch.setattr(cg, "CHUNK_SYMXJ", 1024)
    rng = np.random.default_rng(12)
    pos = torch.from_numpy(rng.normal(size=(3000, 3)) + [8000.0, 0.0, 3.0])
    vel = torch.from_numpy(rng.normal(size=(3000, 3)) * 0.5)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 3000) / 3000)
    pos, vel, mass = pos.to(cuda), vel.to(cuda), mass.to(cuda)
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    eps = 1.0 / 64
    if jerk:
        out = cg.accel_jerk_x(pos, vel, mass, eps, 1.3, False)
        again = cg.accel_jerk_x(pos, vel, mass, eps, 1.3, False)
        ref = gravity.accel_jerk_direct(pos, vel, mass, eps, 1.3)
        tols = (2e-5, 5e-5)
        keys = ("sym_jerk_x", "cross_jerk_x")
    else:
        out = cg.accel_potential_x(pos, mass, eps, 1.3, False)
        again = cg.accel_potential_x(pos, mass, eps, 1.3, False)
        ref = gravity.accel_potential_direct(pos, mass, eps, 1.3)
        tols = (2e-5, 5e-6)
        keys = ("sym_x", "cross_x")
    # the raw potential holds the softened self term: self_phi cancels it
    done = (out if jerk
            else (out[0], out[1] + gravity.self_phi(mass, eps, 1.3)))
    for got, want, tol in zip(done, ref, tols):
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max())
    torch.cuda.synchronize()
    assert all(cg.LAUNCHES[k] == launches[k] + 6 for k in keys)
    assert cg.PLAIN_CALLS == plain
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_close_pairs_across_chunks_on_the_card(cuda, monkeypatch):
    """The close-pair case with the two stars of every pair in different
    chunks (chunks of 256 of N = 600, STREAM_N lowered), so that K15 and
    K16 carry them: the extended chunked route stays inside 2e-5 of max|a|
    and 5e-5 of max|j| of the f64 oracle, the f32 chunked route errs past
    1e-3."""
    monkeypatch.setattr(cg, "STREAM_N", 512)
    for name in ("CHUNK_SYM", "CHUNK_SYMJ", "CHUNK_SYMX", "CHUNK_SYMXJ"):
        monkeypatch.setattr(cg, name, 256)
    rng = np.random.default_rng(7)
    n, eps = 600, 1e-4
    pos = rng.normal(size=(n, 3))
    pos[300:350] = pos[:50] + 1e-5 * rng.normal(size=(50, 3))
    pos = torch.from_numpy(pos).to(cuda)
    vel = torch.from_numpy(0.3 * rng.normal(size=(n, 3))).to(cuda)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(cuda)
    a_ref, j_ref = gravity.accel_jerk_direct(pos, vel, mass, eps)

    def rel(got, want):
        return float(torch.linalg.norm(got - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    launches = dict(cg.LAUNCHES)
    assert rel(cg.accel(pos, mass, eps), a_ref) > 1e-3
    assert rel(cg.accel_x(pos, mass, eps), a_ref) < 2e-5
    acc, jerk = cg.accel_jerk_x(pos, vel, mass, eps)
    assert rel(acc, a_ref) < 2e-5 and rel(jerk, j_ref) < 5e-5
    torch.cuda.synchronize()
    for key in ("cross", "cross_x", "cross_jerk_x"):
        assert cg.LAUNCHES[key] == launches[key] + 3


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("nr,ns", [(1, 300), (37, 300), (1000, 40000),
                                   (64, 300000), (70000, 70000)])
def test_rows_jerk_x_stream_kernel_matches_plain(cuda, nr, ns, eps):
    """K17 (K9 with Kahan steps across stages and chunks) against its f64
    twin, 2e-5 of max past 16,384 sources; a row count past RT_MAX_ROWS;
    two launches bitwise equal."""
    hi, lo, gm, vhi, vlo = _planes(ns, ns + 13, cuda)
    rows = ((hi[:nr] + 1e-3).contiguous(), lo[:nr].contiguous(),
            (vhi[:nr] - 1e-3).contiguous(), vlo[:nr].contiguous())
    guarded = eps == 0.0
    args = (*rows, hi, lo, vhi, vlo, gm, eps)
    out = cg.rows_jerk_x_stream_kernel(*args, guarded=guarded)
    again = cg.rows_jerk_x_stream_kernel(*args, guarded=guarded)
    ref = cg.rows_jerk_x_stream_plain(*args, dtype=torch.float64,
                                      guarded=guarded)
    _check_x(out, ref, tol=(2e-5, 2e-5) if ns > 16384 else (5e-6, 1e-5))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("guarded", [True, False])
def test_rows_jerk_x_stream_rows_are_independent_of_the_launch(cuda,
                                                               guarded):
    """K17 gives a row the same bits alone, in a subset, or among all
    300,000 rows, and the dispatcher takes it past either cap."""
    hi, lo, gm, vhi, vlo = _planes(300000, 8, cuda)
    eps = 0.0 if guarded else 1.0 / 256
    src = (hi, lo, vhi, vlo)
    launches = dict(cg.LAUNCHES)
    full = cg.accel_jerk_rows_x_hilo(*src, *src, gm, eps, guarded=guarded)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["rows_jerk_x_stream"] == \
        launches["rows_jerk_x_stream"] + 1
    gen = torch.Generator(device="cpu").manual_seed(5)
    for k in (1, 64, 4095):
        rows = torch.randperm(300000, generator=gen)[:k].to(cuda)
        sub = cg.rows_jerk_x_stream_kernel(*(p[rows] for p in src), *src, gm,
                                           eps, guarded=guarded)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


# ---- escape pruning: K18 (and K18<comp>) and K19 ---------------------------

@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("nr,ns", [(1, 300), (37, 4097), (1000, 40000),
                                   (4096, 65536), (70000, 300000)])
def test_rows_t_kernel_matches_plain(cuda, nr, ns, comp, with_phi, eps):
    """K18 (compensated or not) against its f64 twin: 5e-6 of max|a| up to
    16,384 sources, 2e-5 past them (PERF.md section 2), phi rtol 3e-5; two
    launches bitwise equal."""
    src, mass = _cluster(ns, ns + 17, cuda)
    rows = (src[torch.arange(nr, device=cuda) % ns] + 0.01).contiguous()
    launch = cg.rows_stream_kernel if comp else cg.rows_t_kernel
    args = (rows, src, mass, eps, 1.3, with_phi)
    out = launch(*args, guarded=eps == 0.0)
    again = launch(*args, guarded=eps == 0.0)
    ref = cg.rows_plain(*args, dtype=torch.float64, chunk=256)
    out, again, ref = ((x if with_phi else (x,)) for x in (out, again, ref))
    tol = 2e-5 if ns > 16384 else 5e-6
    err = float((out[0].double() - ref[0]).abs().max())
    assert out[0].dtype == torch.float32
    assert err <= tol * float(ref[0].abs().max())
    if with_phi:
        torch.testing.assert_close(out[1].double(), ref[1], rtol=3e-5,
                                   atol=0.0)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("comp", [False, True])
def test_rows_t_rows_are_independent_of_the_launch(cuda, comp):
    """K18 gives a row the same bits alone, in a subset, or among all
    rows, with and without the potential (the pruned scatter writes the
    bucket's padding rows twice and needs them equal)."""
    n = 300000 if comp else 65536
    src, mass = _cluster(n, 21, cuda)
    launch = cg.rows_stream_kernel if comp else cg.rows_t_kernel
    rows_all = src[:8192].contiguous()
    full = launch(rows_all, src, mass, 1.0 / 256, with_phi=True,
                  guarded=False)
    gen = torch.Generator(device="cpu").manual_seed(6)
    for k in (1, 64, 4095):
        rows = torch.randperm(8192, generator=gen)[:k].to(cuda)
        sub = launch(rows_all[rows].contiguous(), src, mass, 1.0 / 256,
                     with_phi=True, guarded=False)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nr,ns", [(1, 300), (37, 4097), (70000, 4096),
                                   (64, 300000)])
def test_rows_x_stream_kernel_matches_plain(cuda, nr, ns, with_phi, eps):
    """K19 against the f64 evaluation of the same (hi, lo) planes: 5e-6 of
    max|a| up to 16,384 sources, 2e-5 past them, phi rtol 3e-5; many rows
    against few sources and few against many; two launches bitwise
    equal."""
    hi, lo, gm = _planes(ns, ns + 19, cuda, vel=False)
    sel = torch.arange(nr, device=cuda) % ns
    rows = ((hi[sel] + 1e-3).contiguous(), lo[sel].contiguous())
    args = (*rows, hi, lo, gm, eps, with_phi)
    out = cg.rows_x_stream_kernel(*args, guarded=eps == 0.0)
    again = cg.rows_x_stream_kernel(*args, guarded=eps == 0.0)
    ref = cg.rows_x_stream_plain(*args, dtype=torch.float64,
                                 guarded=eps == 0.0)
    tol = 2e-5 if ns > 16384 else 5e-6
    _check_x(out, ref, tol=(tol,), phi=with_phi)
    out = out if with_phi else (out,)
    again = again if with_phi else (again,)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_rows_x_stream_rows_are_independent_of_the_launch(cuda):
    """K19 gives a row the same bits alone, in a subset, or among all
    rows."""
    hi, lo, gm = _planes(131072, 23, cuda, vel=False)
    full = cg.rows_x_stream_kernel(hi, lo, hi[:4096].contiguous(),
                                   lo[:4096].contiguous(), gm[:4096], 1e-3,
                                   with_phi=True, guarded=False)
    gen = torch.Generator(device="cpu").manual_seed(7)
    for k in (1, 64, 4095):
        rows = torch.randperm(131072, generator=gen)[:k].to(cuda)
        sub = cg.rows_x_stream_kernel(hi[rows], lo[rows],
                                      hi[:4096].contiguous(),
                                      lo[:4096].contiguous(), gm[:4096],
                                      1e-3, with_phi=True, guarded=False)
        for got, want in zip(sub, full):
            assert torch.equal(got, want[rows])


@pytest.mark.parametrize("tier", ["f32", "extended"])
def test_compensated_rows_kernels_beat_their_uncompensated_layout(cuda, tier):
    """The Kahan steps of #4/#5 (K18<comp>) and #13/#14 (K19) at 512 rows x
    300,000 sources, past STREAM_N, against the f64 twin: the compensated
    kernel errs at most 5e-7 of max|a|, and at most a third of what the
    same source-split layout errs without its Kahan steps on the same
    operands (K18; K9's accel at the extended tier). A kernel that dropped
    them, or a wrapper that asked for the uncompensated form, fails."""
    ns, nr, eps = 300000, 512, 1.0 / 256
    if tier == "f32":
        src, mass = _cluster(ns, 29, cuda)
        rows = src[:nr].contiguous()
        ref = cg.rows_plain(rows, src, mass, eps, dtype=torch.float64,
                            chunk=64)
        comp = cg.rows_stream_kernel(rows, src, mass, eps, guarded=False)
        plain = cg.rows_t_kernel(rows, src, mass, eps, guarded=False)
    else:
        hi, lo, gm, vhi, vlo = _planes(ns, 31, cuda)
        rows = [t[:nr].contiguous() for t in (hi, lo, vhi, vlo)]
        ref = cg.rows_x_stream_plain(*rows[:2], hi, lo, gm, eps,
                                     dtype=torch.float64, chunk=64,
                                     guarded=False)
        comp = cg.rows_x_stream_kernel(*rows[:2], hi, lo, gm, eps,
                                       guarded=False)
        plain = cg.rows_jerk_x_kernel(*rows, hi, lo, vhi, vlo, gm, eps,
                                      guarded=False)[0]
    scale = float(ref.abs().max())
    err, err_plain = (float((x.double() - ref).abs().max()) / scale
                      for x in (comp, plain))
    print(f"{tier}: compensated {err:.3e}, uncompensated {err_plain:.3e} "
          "of max|a|")
    assert err <= 5e-7
    assert 3 * err <= err_plain


@pytest.mark.parametrize("precision", ["f32", "extended"])
def test_pruned_block_graphs_agree_with_eager(cuda, precision):
    """Block micro-steps under a pruned force on the card (c4's scene at N
    = 4,096): the CUDA-graph replay equals the eager micro-step bit for
    bit, also across a re-partition of the same bucket size (the graphs'
    partition buffers are reloaded, not re-captured), and the pruned run
    differs from the unpruned one."""
    import os
    from oc_nbody_tpu_torch import escape
    from oc_nbody_tpu_torch.config import apply_overrides, load_config
    from oc_nbody_tpu_torch.integrators.block import BlockHermite
    from oc_nbody_tpu_torch.scene import build_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c4_block_32k_eccentric.toml")
    over = ["ic.n=4096", f"integrator.precision={precision}"]
    cfg = apply_overrides(load_config(path), over)
    scene = build_scene(cfg, cuda)
    pos = scene.state.pos
    r = torch.linalg.vector_norm(pos - pos.mean(dim=0), dim=1).cpu().numpy()
    parts = []
    for q in (0.2, 0.15):              # two partitions of one bucket size
        mask = r <= np.quantile(r, q)
        idx, wgt, _ = escape.build_sources(mask, 1024)
        parts.append(scene.force.with_sources(
            torch.from_numpy(idx).to(cuda), torch.from_numpy(wgt).to(cuda),
            torch.from_numpy(mask.astype(np.float64)).to(cuda)))
    assert parts[0].src_idx.shape == parts[1].src_idx.shape
    ic = cfg.integrator
    out = {}
    for eager in (True, False):
        stepper = BlockHermite(force=parts[0], eta=ic.eta,
                               eta_init=ic.eta_init, dt_max=ic.dt_max,
                               n_levels=ic.n_levels)
        if eager:
            object.__setattr__(stepper, "_use_graphs", lambda carry: False)
        carry = stepper.advance(stepper.init(scene.state), 16)
        stepper = stepper.with_force(parts[1])
        out[eager] = stepper.advance(carry, 16)
        if not eager:
            assert len(stepper._graph_cache) == 1
    assert out[True].n_steps == out[False].n_steps == 32
    for a, b in zip(_carry_fields(out[True]), _carry_fields(out[False])):
        assert torch.equal(a, b)
    plain = _block_run(cuda, 4096, 32, over=over[1:])
    assert not torch.equal(plain.acc, out[False].acc)


# ---- the two-float (df32) tier: K10, K11 -----------------------------------

def _df_planes(n, seed, device, eps, close=0):
    """(hi, lo, vhi, vlo, gm_hi, gm_lo, e2h, e2l) of a cluster 8 kpc from
    the origin, ``close`` of its particles 1e-5 from a partner."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos[close:2 * close] = pos[:close] + 1e-5 * rng.normal(size=(close, 3))
    pos = torch.from_numpy(pos + [8000.0, 0.0, 3.0]).to(device)
    vel = torch.from_numpy(rng.normal(size=(n, 3)) * 0.5
                           + [0.0, 220.0, 0.0]).to(device)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(device)
    hi, lo, gm_hi, gm_lo, e2h, e2l, vhi, vlo = df32._df_prepare(
        pos, mass, eps, 1.3, vel=vel)
    return hi, lo, vhi, vlo, gm_hi, gm_lo, e2h, e2l


def _check_df(out, ref, tols):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for got, want, tol in zip(out, ref, tols):
        assert got.dtype == want.dtype == torch.float64
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (err, tol)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 4096])
@pytest.mark.parametrize("n", [1, 33, 255, 257, 1000, 10650])
def test_rows_df_kernel_matches_f64_and_repeats_bitwise(cuda, n, eps):
    hi, lo, _, _, *rest = _df_planes(n, n, cuda, eps, close=n // 20)
    guarded = eps == 0.0
    out = cuda_df.rows_df_kernel(hi, lo, hi, lo, *rest, guarded=guarded)
    again = cuda_df.rows_df_kernel(hi, lo, hi, lo, *rest, guarded=guarded)
    ref = cuda_df.rows_df_plain(hi, lo, hi, lo, *rest, dtype=torch.float64,
                                guarded=guarded)
    _check_df(out, ref, (1e-9,))
    assert torch.equal(out, again)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 4096])
@pytest.mark.parametrize("n", [1, 33, 255, 257, 1000, 10650])
def test_rows_jerk_df_kernel_matches_f64_and_repeats_bitwise(cuda, n, eps):
    hi, lo, vhi, vlo, *rest = _df_planes(n, n + 1, cuda, eps, close=n // 20)
    planes = (hi, lo, vhi, vlo)
    guarded = eps == 0.0
    out = cuda_df.rows_jerk_df_kernel(*planes, *planes, *rest,
                                      guarded=guarded)
    again = cuda_df.rows_jerk_df_kernel(*planes, *planes, *rest,
                                        guarded=guarded)
    ref = cuda_df.rows_jerk_df_plain(*planes, *planes, *rest,
                                     dtype=torch.float64, guarded=guarded)
    _check_df(out, ref, (1e-9, 1e-8))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("nr,ns", [(37, 300), (1000, 4097)])
def test_df_kernels_on_rows_that_are_not_the_sources(cuda, nr, ns):
    hi, lo, vhi, vlo, *rest = _df_planes(ns, ns, cuda, 1e-3)
    src = (hi, lo, vhi, vlo)
    # shifted rows: the hi words move, the lo words stay (a valid pair)
    rows = ((hi[:nr] + 0.01).contiguous(), lo[:nr].contiguous(),
            (vhi[:nr] - 0.01).contiguous(), vlo[:nr].contiguous())
    _check_df(cuda_df.rows_df_kernel(*rows[:2], hi, lo, *rest),
              cuda_df.rows_df_plain(*rows[:2], hi, lo, *rest,
                                    dtype=torch.float64), (1e-9,))
    _check_df(cuda_df.rows_jerk_df_kernel(*rows, *src, *rest),
              cuda_df.rows_jerk_df_plain(*rows, *src, *rest,
                                         dtype=torch.float64), (1e-9, 1e-8))


def test_df_kernels_match_their_f32_twins(cuda):
    """The kernels and the twins are the same tier: they agree far inside
    the tier's distance from f64 (the kernels fuse the products' cross
    terms, the twins round them apart)."""
    hi, lo, vhi, vlo, *rest = _df_planes(600, 9, cuda, 1e-4, close=50)
    planes = (hi, lo, vhi, vlo)
    _check_df(cuda_df.rows_df_kernel(hi, lo, hi, lo, *rest),
              cuda_df.rows_df_plain(hi, lo, hi, lo, *rest), (1e-10,))
    _check_df(cuda_df.rows_jerk_df_kernel(*planes, *planes, *rest),
              cuda_df.rows_jerk_df_plain(*planes, *planes, *rest),
              (1e-10, 1e-9))


def test_device_error_free_transforms_are_exact(cuda):
    """s + e == a + b and p + e == a b exactly in f64 on 1e5 f32 pairs of
    mixed magnitude (2^-12 .. 2^12, so both f64 checks are exact), and
    df_rsqrt inside 1e-13 relative."""
    rng = np.random.default_rng(3)
    n = 100_000
    a, b = (torch.from_numpy(
        (rng.normal(size=n) * np.exp2(rng.integers(-12, 13, n)))
        .astype(np.float32)).to(cuda) for _ in range(2))
    x = torch.from_numpy(np.exp(rng.uniform(-14.0, 7.0, n))).to(cuda)
    xh, xl = df32.df_from_f64(x)
    s, se, p, pe, yh, yl = (t.double() for t in
                            cuda_df.eft_selftest_kernel(a, b, xh, xl))
    assert torch.equal(s + se, a.double() + b.double())
    assert torch.equal(p + pe, a.double() * b.double())
    assert float((((yh + yl) - x ** -0.5) * x ** 0.5).abs().max()) < 1e-13
    # the twins' transforms on the same inputs give the same words
    for got, want in zip(cuda_df.eft_selftest_kernel(a, b, xh, xl)[:4],
                         cuda_df.eft_selftest_plain(a, b, xh, xl)[:4]):
        assert torch.equal(got, want)


def test_close_pairs_at_the_df32_tier_on_the_card(cuda):
    """The close-pair case: K10 and K11 inside 1e-9 of max|a| and 1e-8 of
    max|j| of the f64 oracle of the unsplit state (the extended kernels:
    ~1e-6, the f32 kernels: ~5e-3)."""
    rng = np.random.default_rng(7)
    n, eps = 600, 1e-4
    pos = rng.normal(size=(n, 3))
    pos[50:100] = pos[:50] + 1e-5 * rng.normal(size=(50, 3))
    pos = torch.from_numpy(pos).to(cuda)
    vel = torch.from_numpy(0.3 * rng.normal(size=(n, 3))).to(cuda)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(cuda)
    a_ref, j_ref = gravity.accel_jerk_direct(pos, vel, mass, eps)

    def rel(got, want):
        return float(torch.linalg.norm(got - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    launches = dict(cg.LAUNCHES)
    assert rel(cuda_df.accel_df(pos, mass, eps, guarded=False), a_ref) < 1e-9
    acc, jerk = cuda_df.accel_jerk_df(pos, vel, mass, eps, guarded=False)
    assert rel(acc, a_ref) < 1e-9 and rel(jerk, j_ref) < 1e-8
    assert cg.LAUNCHES["rows_df"] == launches["rows_df"] + 1
    assert cg.LAUNCHES["rows_jerk_df"] == launches["rows_jerk_df"] + 1
    # a kernel that dropped the lo planes would be the f32 tier
    hi, lo, *rest = df32._df_prepare(pos, mass, eps, 1.0)
    zero = torch.zeros_like(lo)
    assert rel(cuda_df.rows_df_kernel(hi, zero, hi, zero, *rest),
               a_ref) > 1e-3


def test_guarded_coincident_pair_adds_nothing_at_the_df32_tier(cuda):
    z = torch.zeros((2, 3), dtype=torch.float32, device=cuda)
    vel = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], dtype=torch.float32,
                       device=cuda)
    gm = torch.ones(2, dtype=torch.float32, device=cuda)
    gl = torch.zeros(2, dtype=torch.float32, device=cuda)
    outs = (cuda_df.rows_df_kernel(z, z, z, z, gm, gl, 0.0, 0.0,
                                   guarded=True),
            *cuda_df.rows_jerk_df_kernel(z, z, vel, z, z, z, vel, z, gm, gl,
                                         0.0, 0.0, guarded=True))
    for out in outs:
        assert bool((out == 0).all())


def test_df_launchers_check_their_input(cuda):
    hi, lo, vhi, vlo, *rest = _df_planes(64, 2, cuda, 0.1)
    with pytest.raises(TypeError, match="float32"):
        cuda_df.rows_df_kernel(hi.double(), lo, hi, lo, *rest)
    with pytest.raises(ValueError, match="shape"):
        cuda_df.rows_jerk_df_kernel(hi, lo, vhi, vlo[:10], hi, lo, vhi, vlo,
                                    *rest)
    with pytest.raises(NotImplementedError, match="STREAM_N"):
        big = torch.zeros((cg.STREAM_N + 1, 3), dtype=torch.float64,
                          device=cuda)
        cuda_df.accel_df(big, big[:, 0], 0.1)


@pytest.mark.parametrize("n", [1000, 10650])
def test_extended_kernels_at_ragged_sizes(cuda, n):
    """K6 with the potential, K7 and K9 at sizes that fill no tile, chunk
    or stage evenly (10,650: the binaries config's star count)."""
    hi, lo, gm, vhi, vlo = _planes(n, n + 3, cuda)
    src = (hi, lo, vhi, vlo)
    eps = 1.0 / 4096
    f64 = torch.float64
    _check_x(cg.sym_x_kernel(hi, lo, gm, eps, with_phi=True, guarded=False),
             cg.sym_x_plain(hi, lo, gm, eps, with_phi=True, dtype=f64),
             phi=True)
    out = cg.sym_jerk_x_kernel(*src, gm, eps, guarded=False)
    _check_x(out, cg.sym_jerk_x_plain(*src, gm, eps, dtype=f64))
    assert all(torch.equal(a, b) for a, b in zip(
        out, cg.sym_jerk_x_kernel(*src, gm, eps, guarded=False)))
    full = cg.rows_jerk_x_kernel(*src, *src, gm, eps, guarded=False)
    _check_x(full, cg.rows_jerk_x_plain(*src, *src, gm, eps, dtype=f64))
    rows = torch.arange(n - 37, n, device=cuda)       # the ragged tail
    sub = cg.rows_jerk_x_kernel(*(p[rows] for p in src), *src, gm, eps,
                                guarded=False)
    assert all(torch.equal(a, b[rows]) for a, b in zip(sub, full))


@pytest.mark.parametrize("over", [[], ["integrator.precision=extended"]],
                         ids=["f32", "extended"])
def test_block_graphs_with_pec2_agree_bitwise(cuda, over):
    """With pec2 the micro-step replays three CUDA graphs around two force
    launches: equal to the eager micro-step and to the masked evaluation,
    bit for bit."""
    eager = _block_run(cuda, 4096, 16, eager=True, over=over, pec2=True)
    graphs = _block_run(cuda, 4096, 16, over=over, pec2=True)
    masked = _block_run(cuda, 4096, 16, n_buckets=0, over=over, pec2=True)
    plain = _block_run(cuda, 4096, 16, over=over)
    assert not torch.equal(plain.state.pos, graphs.state.pos)
    for other in (graphs, masked):
        assert other.n_steps == eager.n_steps == 16
        assert other.n_active_sum == eager.n_active_sum
        for a, b in zip(_carry_fields(other), _carry_fields(eager)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("pec2", [False, True])
def test_block_graphs_at_df32_agree_with_eager(cuda, pec2):
    """At the df32 tier K11 launches once, at init, and the active rows are
    eager f64 sums into an f64 pair buffer between the graph replays: the
    same bits as the eager micro-step; the masked evaluation sums other
    shapes, so it agrees to f64 rounding."""
    over = ["integrator.precision=df32"]
    launches = dict(cg.LAUNCHES)
    eager = _block_run(cuda, 4096, 16, eager=True, over=over, pec2=pec2)
    assert cg.LAUNCHES["rows_jerk_df"] == launches["rows_jerk_df"] + 1
    assert cg.LAUNCHES["rows_jerk_x"] == launches["rows_jerk_x"]
    assert cg.LAUNCHES["rows_jerk"] == launches["rows_jerk"]
    graphs = _block_run(cuda, 4096, 16, over=over, pec2=pec2)
    masked = _block_run(cuda, 4096, 16, n_buckets=0, over=over, pec2=pec2)
    assert graphs.n_active_sum == eager.n_active_sum == masked.n_active_sum
    for a, b in zip(_carry_fields(graphs), _carry_fields(eager)):
        assert torch.equal(a, b)
    for a, b in zip(_carry_fields(masked), _carry_fields(eager)):
        if a.dtype == torch.int64:
            assert torch.equal(a, b)
        else:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-11 * scale


def _ring_step(key, ops, eps, sums, comps, first, twin=False):
    """K20 / K20<phi> / K21 (or, with ``twin``, its plain twin in the
    sums' dtype) on ``ops`` = (rows, [vrows,] src, [svel,] gm), in place."""
    if key == "ring_jerk":
        fn = cuda_ring.ring_step_jerk_plain if twin else \
            cuda_ring.ring_step_jerk_kernel
        args = (*ops, eps, sums[0], sums[1], comps[0], comps[1])
    else:
        fn = cuda_ring.ring_step_plain if twin else cuda_ring.ring_step_kernel
        args = (*ops, eps, sums[0], comps[0],
                *((sums[1], comps[1]) if key == "ring_phi" else ()))
    kw = dict(dtype=sums[0].dtype) if twin else dict(guarded=eps == 0.0)
    fn(*args, first=first, **kw)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 256])
@pytest.mark.parametrize("key", ["ring", "ring_phi", "ring_jerk"])
@pytest.mark.parametrize("nr,ns", [(1, 1), (127, 129), (2664, 2664),
                                   (300, 4097)])
def test_ring_step_kernels_match_their_twins(cuda, key, nr, ns, eps):
    """K20, K20<phi> and K21: the first step stores and zeroes the
    compensations; a step onto non-zero incoming sums adds by a Kahan
    step (sum - comp grows by the f64 step); two launches from the same
    incoming sums are bitwise equal."""
    pos, mass, vel = _moving_cluster(nr + ns, nr + ns, cuda)
    ops = ((pos[:nr], vel[:nr], pos[nr:], vel[nr:], mass[nr:])
           if key == "ring_jerk" else (pos[:nr], pos[nr:], mass[nr:]))
    ops = tuple(t.contiguous() for t in ops)
    shapes = {"ring": [(nr, 3)], "ring_phi": [(nr, 3), (nr,)],
              "ring_jerk": [(nr, 3), (nr, 3)]}[key]

    def zeros(dtype):
        return [torch.zeros(sh, dtype=dtype, device=cuda) for sh in shapes]

    step64, c64 = zeros(torch.float64), zeros(torch.float64)
    _ring_step(key, ops, eps, step64, c64, True, twin=True)
    first = zeros(torch.float32)
    comps = [torch.ones(sh, device=cuda) for sh in shapes]
    _ring_step(key, ops, eps, first, comps, True)
    assert all(float(c.abs().max()) == 0.0 for c in comps)
    out0 = [3.0 * t + 1.0 for t in first]
    comp0 = [1e-7 * t for t in out0]
    sums = [[t.clone() for t in out0] for _ in range(2)]
    cps = [[t.clone() for t in comp0] for _ in range(2)]
    for s, c in zip(sums, cps):
        _ring_step(key, ops, eps, s, c, False)
    for a, b in zip(sums[0] + cps[0], sums[1] + cps[1]):
        assert torch.equal(a, b)
    for i, (got, want) in enumerate(zip(first, step64)):
        grown = ((sums[0][i].double() - cps[0][i].double())
                 - (out0[i].double() - comp0[i].double()))
        tol = 5e-6 if i == 0 or key == "ring_phi" else 1e-5
        scale = float(want.abs().max())
        if key == "ring_phi" and i == 1:
            torch.testing.assert_close(got.double(), want, rtol=3e-5, atol=0)
            torch.testing.assert_close(grown, want, rtol=3e-5,
                                       atol=1e-7 * float(out0[1].abs().max()))
        else:
            assert float((got.double() - want).abs().max()) <= tol * scale
            assert float((grown - want).abs().max()) <= (
                tol * scale + 1e-7 * float(out0[i].abs().max()))


@pytest.mark.parametrize("mode", ["allgather", "ring", "rdma", "halfring"])
def test_sharded_force_on_the_card_matches_unsharded(cuda, mode):
    """Every mode on 4 shards of the card, N = 10,650 (ragged: 2,664 a
    shard): accel, accel + phi, accel + jerk within 2e-5 of the unsharded
    ForceModel's (phi rtol 3e-5), each bitwise repeatable."""
    from oc_nbody_tpu_torch.forces import make_force_model
    from oc_nbody_tpu_torch.parallel.force import make_sharded_force
    from oc_nbody_tpu_torch.parallel.mesh import Mesh
    rng = np.random.default_rng(10650)
    pos = torch.from_numpy(rng.normal(size=(10650, 3))).to(cuda)
    vel = torch.from_numpy(0.3 * rng.normal(size=(10650, 3))).to(cuda)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 10650) / 10650).to(
        cuda, torch.float32)
    sf = make_sharded_force(1.0 / 256, mesh=Mesh.on_one_device(4, cuda),
                            mode=mode)
    single = make_force_model(1.0 / 256)
    for name, call in (("accel", lambda f: (f.accel(pos, mass),)),
                       ("phi", lambda f: f.accel_potential(pos, mass)[:2]),
                       ("jerk", lambda f: f.accel_jerk(pos, vel, mass))):
        got, again, want = call(sf), call(sf), call(single)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        for i, (g, w) in enumerate(zip(got, want)):
            if name == "phi" and i == 1:
                torch.testing.assert_close(g, w, rtol=3e-5, atol=0)
            else:
                assert float((g - w).abs().max()) <= 2e-5 * float(
                    w.abs().max()), (mode, name, i)


def test_ring_evaluations_are_race_free_and_launch_d_squared(cuda):
    """The overlapped ring (compute and copy streams, events) equals the
    same schedule with the host waiting after every ring step, bitwise,
    over repeats; d = 1 is one launch with no slab; each evaluation is d^2
    launches."""
    pos, mass, vel = _moving_cluster(16384, 3, cuda)
    d, size = 4, 4096
    ps = [pos[s * size:(s + 1) * size] for s in range(d)]
    vs = [vel[s * size:(s + 1) * size] for s in range(d)]
    ms = [mass[s * size:(s + 1) * size] for s in range(d)]
    buffers = cuda_ring.RingBuffers()
    for key, fn in (
            ("ring", lambda serial: cuda_ring.accel_ring(
                ps, ms, 1.0 / 256, serial=serial, buffers=buffers)),
            ("ring_phi", lambda serial: cuda_ring.accel_potential_ring(
                ps, ms, 1.0 / 256, serial=serial, buffers=buffers)),
            ("ring_jerk", lambda serial: cuda_ring.accel_jerk_ring(
                ps, vs, ms, 1.0 / 256, serial=serial, buffers=buffers))):
        def flat(out):
            return [t for o in out for t in (o if isinstance(o, tuple)
                                             else (o,))]
        before = cg.LAUNCHES[key]
        serial = flat(fn(True))
        assert cg.LAUNCHES[key] - before == d * d
        for _ in range(3):
            assert all(torch.equal(a, b)
                       for a, b in zip(flat(fn(False)), serial)), key
    one_shard = cuda_ring.RingBuffers()
    before = cg.LAUNCHES["ring"]
    (one,) = cuda_ring.accel_ring([pos], [mass], 1.0 / 256,
                                  buffers=one_shard)
    assert cg.LAUNCHES["ring"] - before == 1 and not one_shard.rings
    ref = cg.rows_plain(pos, pos, mass, 1.0 / 256, dtype=torch.float64)
    assert float((one.double() - ref).abs().max()) <= 2e-5 * float(
        ref.abs().max())


# ---- the zero guard at eps = 0 (one rule for every kernel) -----------------

def _close_pair_set(device, n=64, sep=1e-20):
    """n stars in f32, the last two ``sep`` apart on each axis (u = 3 sep^2,
    below the least normal f32 at 1e-20), the rest a normal sample."""
    rng = np.random.default_rng(61)
    pos = rng.normal(size=(n, 3))
    pos[-2] = 0.0
    pos[-1] = sep
    vel = rng.normal(size=(n, 3)) * 0.5
    mass = rng.uniform(0.5, 1.5, n) / n
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.float32)
                 for a in (pos, vel, mass))


def _guard_cases(device):
    """(label, kernel outputs, f32 plain twin outputs) of every guarded
    kernel K1-K21 at eps = 0 on ``_close_pair_set``, rows = sources (the
    cross kernels take the first 40 stars against the rest)."""
    pos, vel, mass = _close_pair_set(device)
    z = torch.zeros_like(pos)
    f32, e = torch.float32, 0.0
    rows = dict(guarded=True)
    A = (pos[:40].contiguous(), vel[:40].contiguous())
    B = (pos[40:].contiguous(), vel[40:].contiguous())
    mA, mB = mass[:40].contiguous(), mass[40:].contiguous()
    zA, zB = torch.zeros_like(A[0]), torch.zeros_like(B[0])
    hi_lo = (pos, z, vel, z)
    cases = [
        ("K1", cg.rows_kernel(pos, pos, mass, e, with_phi=True, **rows),
         cg.rows_plain(pos, pos, mass, e, with_phi=True)),
        ("K2", cg.sym_kernel(pos, mass, e, with_phi=True, **rows),
         cg.sym_plain(pos, mass, e, with_phi=True)),
        ("K3", cg.sym_jerk_kernel(pos, vel, mass, e, **rows),
         cg.sym_jerk_plain(pos, vel, mass, e)),
        ("K4", cg.rows_jerk_kernel(pos, vel, pos, vel, mass, e, **rows),
         cg.rows_jerk_plain(pos, vel, pos, vel, mass, e)),
        ("K5", cg.rows_jerk_t_kernel(pos, vel, pos, vel, mass, e, **rows),
         cg.rows_jerk_t_plain(pos, vel, pos, vel, mass, e)),
        ("K6", cg.sym_x_kernel(pos, z, mass, e, with_phi=True, **rows),
         cg.sym_x_plain(pos, z, mass, e, with_phi=True)),
        ("K7", cg.sym_jerk_x_kernel(*hi_lo, mass, e, **rows),
         cg.sym_jerk_x_plain(*hi_lo, mass, e)),
        ("K8", cg.rows_x_kernel(pos, z, pos, z, mass, e, with_phi=True,
                                **rows),
         cg.rows_x_plain(pos, z, pos, z, mass, e, with_phi=True)),
        ("K9", cg.rows_jerk_x_kernel(*hi_lo, *hi_lo, mass, e, **rows),
         cg.rows_jerk_x_plain(*hi_lo, *hi_lo, mass, e)),
        ("K12", cg.cross_kernel(A[0], B[0], mA, mB, e, with_phi=True, **rows),
         cg.cross_plain(A[0], B[0], mA, mB, e, with_phi=True)),
        ("K13", cg.cross_jerk_kernel(*A, *B, mA, mB, e, **rows),
         cg.cross_jerk_plain(*A, *B, mA, mB, e)),
        ("K14", cg.rows_jerk_stream_kernel(pos, vel, pos, vel, mass, e,
                                           **rows),
         cg.rows_jerk_stream_plain(pos, vel, pos, vel, mass, e)),
        ("K15", cg.cross_x_kernel(A[0], zA, B[0], zB, mA, mB, e,
                                  with_phi=True, **rows),
         cg.cross_x_plain(A[0], zA, B[0], zB, mA, mB, e, with_phi=True)),
        ("K16", cg.cross_jerk_x_kernel(A[0], zA, A[1], zA, B[0], zB, B[1],
                                       zB, mA, mB, e, **rows),
         cg.cross_jerk_x_plain(A[0], zA, A[1], zA, B[0], zB, B[1], zB, mA,
                               mB, e)),
        ("K17", cg.rows_jerk_x_stream_kernel(*hi_lo, *hi_lo, mass, e,
                                             **rows),
         cg.rows_jerk_x_stream_plain(*hi_lo, *hi_lo, mass, e)),
        ("K18", cg.rows_t_kernel(pos, pos, mass, e, with_phi=True, **rows),
         cg.rows_plain(pos, pos, mass, e, with_phi=True)),
        ("K18<comp>", cg.rows_stream_kernel(pos, pos, mass, e, with_phi=True,
                                            **rows),
         cg.rows_plain(pos, pos, mass, e, with_phi=True)),
        ("K19", cg.rows_x_stream_kernel(pos, z, pos, z, mass, e,
                                        with_phi=True, **rows),
         cg.rows_x_stream_plain(pos, z, pos, z, mass, e, with_phi=True)),
    ]
    # the df32 planes as they stand (no centring, which would merge the
    # pair): lo words zero, eps^2 = (0, 0)
    df_pv = (pos, z, vel, z)
    gz = torch.zeros_like(mass)
    cases += [
        ("K10", cuda_df.rows_df_kernel(pos, z, pos, z, mass, gz, 0.0, 0.0),
         cuda_df.rows_df_plain(pos, z, pos, z, mass, gz, 0.0, 0.0)),
        ("K11", cuda_df.rows_jerk_df_kernel(*df_pv, *df_pv, mass, gz, 0.0,
                                            0.0),
         cuda_df.rows_jerk_df_plain(*df_pv, *df_pv, mass, gz, 0.0, 0.0)),
    ]
    for key, ops in (("ring", (pos, pos, mass)),
                     ("ring_phi", (pos, pos, mass)),
                     ("ring_jerk", (pos, vel, pos, vel, mass))):
        shapes = [(64, 3), (64,) if key == "ring_phi" else (64, 3)]
        shapes = shapes[:1] if key == "ring" else shapes
        got, want = ([torch.zeros(sh, dtype=f32, device=device)
                      for sh in shapes] for _ in range(2))
        comps = [[torch.zeros(sh, dtype=f32, device=device) for sh in shapes]
                 for _ in range(2)]
        _ring_step(key, ops, e, got, comps[0], True)
        _ring_step(key, ops, e, want, comps[1], True, twin=True)
        cases.append(({"ring": "K20", "ring_phi": "K20<phi>",
                       "ring_jerk": "K21"}[key], tuple(got), tuple(want)))
    return cases


# the kernels whose outputs alternate accel, jerk
_JERK_KERNELS = ("K3", "K4", "K5", "K7", "K9", "K11", "K13", "K14", "K16",
                 "K17", "K21")


def test_guarded_kernels_give_a_pair_closer_than_1e_19_nothing(cuda):
    """C6: at eps = 0 a pair 1e-20 apart (u = 3e-40, below the least normal
    f32) adds nothing in every guarded kernel K1-K21, as in its plain twin
    (gravity._inv_r) and in the JAX package, whose f32 arithmetic flushes
    that u to 0 (tests/test_torch_guard.py): the kernel's non-finite
    entries are its twin's (none), and its finite ones agree at the
    tolerances above (K10, K11: 1e-9 of max|a|, 1e-8 of max|j|)."""
    for label, got, want in _guard_cases(cuda):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), label
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g.double(), w.double()
            assert bool(torch.isfinite(w).all()), (label, k)
            assert torch.equal(torch.isfinite(g), torch.isfinite(w)), label
            phi = w.dim() == 1
            if phi:
                torch.testing.assert_close(g, w, rtol=3e-5, atol=0.0)
                continue
            jerk = label in _JERK_KERNELS and k % 2 == 1
            tol = ((1e-9, 1e-8) if label in ("K10", "K11")
                   else (5e-6, 1e-5))[jerk]
            assert float((g - w).abs().max()) <= tol * float(
                w.abs().max()), (label, k)


# --------------------------------------------------------------------------
# K22: the CH85 k-th-nearest-neighbour sweep (ops/cuda_knn.py)
# --------------------------------------------------------------------------

# integer lattices (pos, mass) made from a seed: every d² exact in f32 in
# any order, masses multiples of 1/8 (exact sums)
_KNN_LATTICES = {
    "ties": dict(n=300, side=3),           # a ragged last tile
    "ties_20k": dict(n=20000, side=10),    # 157 tiles, the last ragged
    "line": dict(pos=[[i, 0, 0] for i in range(7)] + [[3, 0, 0]]),
    # one distinct positive distance
    "two_points": dict(pos=[[0, 0, 0]] * 1500 + [[1, 0, 0]] * 1500),
}


def _knn_lattice(case, device):
    spec = _KNN_LATTICES[case]
    rng = np.random.default_rng(11)
    if "pos" in spec:
        pos = np.asarray(spec["pos"], dtype=np.float64)
    else:
        side = spec["side"]
        pos = rng.integers(-side, side + 1, size=(spec["n"], 3)).astype(
            np.float64)
    mass = rng.integers(1, 9, size=pos.shape[0]) / 8.0
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(mass).to(device))


def _knn_inputs(pos, mass, center, cap=65536):
    """The sweep's inputs as diagnostics.local_density strides, centres
    and casts them."""
    s = -(-pos.shape[0] // cap)
    c = pos - center
    return (c[::s].float().contiguous(), c[::s].float().contiguous(),
            (mass[::s].float() * float(s)).contiguous())


def _twin_on_the_card(monkeypatch):
    """Route the dispatcher's CUDA tensors to the plain twin."""
    monkeypatch.setattr(cuda_knn, "knn_density_kernel",
                        lambda p, s, m, k: cuda_knn.knn_density_plain(
                            p, s, m, k))


@pytest.mark.parametrize("r_min", [0.0, 2.5])
@pytest.mark.parametrize("case", sorted(_KNN_LATTICES))
def test_knn_kernel_keeps_the_twin_ties_bitwise(cuda, monkeypatch, case,
                                                r_min):
    pos, mass = _knn_lattice(case, cuda)
    center = torch.zeros(3, dtype=torch.float64, device=cuda)
    probes, src, msrc = _knn_inputs(pos, mass, center)
    rk2, mnb = cuda_knn.knn_density_kernel(probes, src, msrc, 6)
    want_rk2, want_mnb = cuda_knn.knn_density_plain(probes, src, msrc, 6)
    assert torch.equal(rk2, want_rk2) and torch.equal(mnb, want_mnb)
    if case in ("line", "two_points"):
        assert bool(torch.isinf(rk2).any())   # fewer than k distinct
    rho, _ = tdiag.local_density(pos, mass, center, r_min=r_min)
    _twin_on_the_card(monkeypatch)
    want_rho, _ = tdiag.local_density(pos, mass, center, r_min=r_min)
    assert torch.equal(rho, want_rho)


@pytest.mark.parametrize("n", [1000, 10650, 32768, 65536, 131072])
def test_knn_kernel_matches_the_twin_on_plummer(cuda, monkeypatch, n):
    st = plummer(n, torch.Generator().manual_seed(n), device=cuda)
    center = tdiag.density_center(st)
    probes, src, msrc = _knn_inputs(st.pos, st.mass, center)
    rk2, mnb = cuda_knn.knn_density_kernel(probes, src, msrc, 6)
    again = cuda_knn.knn_density_kernel(probes, src, msrc, 6)
    assert torch.equal(rk2, again[0]) and torch.equal(mnb, again[1])
    want_rk2, want_mnb = cuda_knn.knn_density_plain(probes, src, msrc, 6)
    assert torch.equal(rk2, want_rk2)
    torch.testing.assert_close(mnb, want_mnb, rtol=1e-6, atol=0.0)
    got = tdiag.core_radius_density(st, center=center, r_min=2.0 / 512)
    _twin_on_the_card(monkeypatch)
    want = tdiag.core_radius_density(st, center=center, r_min=2.0 / 512)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)


def test_a_row_launches_k22_once_and_never_the_twin(cuda):
    import os
    from oc_nbody_tpu_torch.config import apply_overrides, load_config
    from oc_nbody_tpu_torch.scene import build_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c1_plummer_1k.toml")
    cfg = apply_overrides(load_config(path), ["ic.n=2048"])
    scene = build_scene(cfg, cuda)
    launches = cg.LAUNCHES["knn_density"]
    plain = cg.PLAIN_CALLS["knn_density"]
    row = tdiag.compute_all(scene.state, scene.force, core=True)
    assert bool(torch.isfinite(row["r_core"]))
    assert cg.LAUNCHES["knn_density"] == launches + 1
    assert cg.PLAIN_CALLS["knn_density"] == plain
