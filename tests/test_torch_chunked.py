"""The f32 tier past one resident set (N > STREAM_N): the port's chunked
pair-symmetric self-interaction and its streamed active-row sum against the
JAX package on identical inputs, on the CPU at small size.

The cross-pair twins (K12 ``cross_plain``, K13 ``cross_jerk_plain``) are
held to ``oc_nbody_tpu/ops/gravity.py``'s cross-pair ops and to the Pallas
cross kernel #20 (``_make_cross_kernel`` with ``_OP_A``, ``_OP_P``,
``_OP_J``) run in interpret mode through ``pallas_gravity.accel_cross_pair``
& co., with the sym tiles at 64 as tests/unit/test_pallas_interpret.py:271
sets them. The chunked forms (``accel_sym_chunked``,
``accel_potential_sym_chunked``, ``accel_jerk_sym_chunked``) are held to
the JAX package's chunked forms at chunk = 128: n = 300 gives three chunks
with a ragged last one (the port keeps it ragged, JAX pads it with
zero-mass particles), n = 100 one chunk. ``accel_jerk_rows`` past STREAM_N
sources (K14's twin) is held to ``accel_jerk_rows_streamed(compensated=
True)`` (#6), and a few KDK steps of c6 at small N with STREAM_N lowered to
the JAX package's step from the same IC. Tolerances are the JAX package's
own (test_pallas_interpret.py:51-59): accel 5e-6·max|a|, phi rtol 3e-5,
jerk 1e-5·max|j| (its f32 sum differences two terms of one size); the
f64 twins match the f64 oracle to 1e-12.
"""
import jax
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from test_torch_slice import REPO, numpy_plummer

G = 1.3
CHUNK = 128
C6 = f"{REPO}/configs/c6_1m_streamed.toml"
_PALLAS = (pg.accel_cross_pair, pg.accel_potential_cross_pair,
           pg.accel_jerk_cross_pair, pg.accel_sym_chunked,
           pg.accel_potential_sym_chunked, pg.accel_jerk_sym_chunked,
           pg.accel_jerk_rows_streamed, pg.accel_jerk_rows)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    for name in ("T_SYMA", "T_SYMP", "T_SYM"):
        monkeypatch.setattr(pg, name, 64)
    for fn in _PALLAS:
        fn.clear_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    for fn in _PALLAS:
        fn.clear_cache()


def _moving_cluster(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.5
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close(got, ref, tol):
    """max |got - ref| <= tol · max |ref|, elementwise over each pair."""
    for g_, r_ in zip(got, ref):
        r_ = np.asarray(r_, np.float64)
        np.testing.assert_allclose(np.asarray(g_, np.float64), r_,
                                   atol=tol * np.abs(r_).max(), rtol=0)


def _close_phi(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=3e-5)


def _two_sets(nA, nB, seed):
    """A and B, disjoint, centred in ONE frame, f32-ready."""
    pos, vel, mass = _moving_cluster(nA + nB, seed)
    pos = pos - pos.mean(axis=0)
    vel = vel - vel.mean(axis=0)
    f32 = [np.asarray(a, np.float32) for a in (pos, vel, mass)]
    return tuple((a[:nA], a[nA:]) for a in f32), (pos, vel, mass)


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("op", ["A", "P", "J"])
def test_cross_twins_match_jax_and_pallas(op, eps):
    """The three cross-pair forms on ragged disjoint sets (150 x 90): the
    port's public wrappers (K12/K13's f32 twins on the CPU) against JAX's
    jnp ops and the Pallas cross kernel in interpret mode; the f64 twins
    against the JAX f64 ops to 1e-12; the potential holds no self term."""
    (pAB, vAB, mAB), (p64, v64, m64) = _two_sets(150, 90, seed=7)
    (pA, pB), (vA, vB), (mA, mB) = pAB, vAB, mAB
    guarded = eps == 0.0
    plain = dict(cg.PLAIN_CALLS)
    if op == "J":
        got = cg.accel_jerk_cross_pair(*(_t(a) for a in (pA, vA, pB, vB, mA,
                                                         mB)), eps, G,
                                       guarded)
        refs = [jgrav.accel_jerk_cross_pair(pA, vA, pB, vB, mA, mB, eps, G),
                pg.accel_jerk_cross_pair(pA, vA, pB, vB, mA, mB, eps, G,
                                         guarded=guarded)]
        key = "cross_jerk"
        f64 = cg.cross_jerk_plain(
            *(_t(a, torch.float64) for a in (p64[:150], v64[:150], p64[150:],
                                             v64[150:], m64[:150],
                                             m64[150:])), eps, G,
            dtype=torch.float64, chunk=64)
        f64_ref = jgrav.accel_jerk_cross_pair(p64[:150], v64[:150],
                                              p64[150:], v64[150:],
                                              m64[:150], m64[150:], eps, G)
    else:
        fn = (cg.accel_potential_cross_pair if op == "P"
              else cg.accel_cross_pair)
        got = fn(*(_t(a) for a in (pA, pB, mA, mB)), eps, G, guarded)
        jfn = (jgrav.accel_potential_cross_pair if op == "P"
               else jgrav.accel_cross_pair)
        pfn = (pg.accel_potential_cross_pair if op == "P"
               else pg.accel_cross_pair)
        refs = [jfn(pA, pB, mA, mB, eps, G),
                pfn(pA, pB, mA, mB, eps, G, guarded=guarded)]
        key = "cross"
        f64 = cg.cross_plain(*(_t(a, torch.float64) for a in (
            p64[:150], p64[150:], m64[:150], m64[150:])), eps, G,
            with_phi=op == "P", dtype=torch.float64, chunk=64)
        f64_ref = jfn(p64[:150], p64[150:], m64[:150], m64[150:], eps, G)
    assert cg.PLAIN_CALLS[key] == plain[key] + 2
    assert [tuple(g_.shape) for g_ in got] == \
        [tuple(np.shape(r_)) for r_ in refs[0]]
    assert all(g_.dtype == torch.float32 for g_ in got)
    for ref in refs:
        if op == "P":    # (accA, phiA, accB, phiB)
            _close(got[0::2], ref[0::2], 5e-6)
            for g_, r_ in zip(got[1::2], ref[1::2]):
                _close_phi(g_, r_)
        else:            # (acc, jerk) per set, or (accA, accB)
            tols = (5e-6, 1e-5) if op == "J" else (5e-6,)
            for k in range(len(got)):
                _close([got[k]], [ref[k]], tols[k % len(tols)])
    for g_, r_ in zip(f64, f64_ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(r_).max()))


@pytest.mark.parametrize("n,eps", [(300, 0.0), (300, 0.05), (100, 0.05)])
def test_chunked_forms_match_jax(n, eps):
    """accel_sym_chunked, accel_potential_sym_chunked and
    accel_jerk_sym_chunked at chunk = 128 (n = 300: chunks of 128, 128 and
    44; n = 100: one chunk) against the JAX package's at the same chunk in
    interpret mode, eps > 0 unguarded and eps = 0 guarded, and against the
    JAX f64 oracle; the route is K2's/K3's twin on each diagonal chunk and
    K12's/K13's on each chunk pair, and no launch is counted."""
    pos, vel, mass = _moving_cluster(n, seed=n + 3)
    guarded = eps == 0.0
    p64, v64, m32 = _t(pos, torch.float64), _t(vel, torch.float64), \
        _t(mass)
    c = -(-n // CHUNK)
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    acc = cg.accel_sym_chunked(p64, m32, eps, G, guarded, chunk=CHUNK)
    acc_p, phi = cg.accel_potential_sym_chunked(p64, m32, eps, G, guarded,
                                                chunk=CHUNK)
    acc_j, jerk = cg.accel_jerk_sym_chunked(p64, v64, m32, eps, G, guarded,
                                            chunk=CHUNK)
    assert cg.LAUNCHES == launches
    assert cg.PLAIN_CALLS["sym"] == plain["sym"] + 2 * c
    assert cg.PLAIN_CALLS["cross"] == plain["cross"] + c * (c - 1)
    assert cg.PLAIN_CALLS["sym_jerk"] == plain["sym_jerk"] + c
    assert cg.PLAIN_CALLS["cross_jerk"] == \
        plain["cross_jerk"] + c * (c - 1) // 2
    assert acc.dtype == phi.dtype == jerk.dtype == torch.float64
    m32n = np.asarray(mass, np.float32)
    kw = dict(guarded=guarded, chunk=CHUNK)
    ref_a = pg.accel_sym_chunked(pos, m32n, eps, G, **kw)
    ref_ap, ref_phi = pg.accel_potential_sym_chunked(pos, m32n, eps, G, **kw)
    ref_aj, ref_j = pg.accel_jerk_sym_chunked(pos, vel, m32n, eps, G, **kw)
    o_a, o_phi = jgrav.accel_potential_direct(pos, mass, eps, G)
    o_aj, o_j = jgrav.accel_jerk_direct(pos, vel, mass, eps, G)
    for ref in (ref_a, o_a):
        _close([acc], [ref], 5e-6)
    for ref_acc, ref_p in ((ref_ap, ref_phi), (o_a, o_phi)):
        _close([acc_p], [ref_acc], 5e-6)
        _close_phi(phi, ref_p)
    for ref in ((ref_aj, ref_j), (o_aj, o_j)):
        _close([acc_j], [ref[0]], 5e-6)
        _close([jerk], [ref[1]], 1e-5)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 32])
@pytest.mark.parametrize("nr", [1, 300])
def test_rows_past_stream_n_match_the_streamed_kernel(monkeypatch, nr, eps):
    """accel_jerk_rows past STREAM_N sources (lowered to 256) routes to
    K14's twin at every row count, RT_MAX_ROWS notwithstanding; it agrees
    with #6 accel_jerk_rows_streamed(compensated=True) in interpret mode,
    with the JAX package's own dispatch past its lowered STREAM_N, and with
    the f64 rows oracle."""
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 16)
    monkeypatch.setattr(pg, "STREAM_N", 256)
    src, svel, mass = _moving_cluster(300, seed=51)
    rows, vrows, _ = _moving_cluster(nr, seed=52 + nr)
    r32, vr32, s32, sv32, m32 = (np.asarray(a, np.float32)
                                 for a in (rows, vrows, src, svel, mass))
    plain = dict(cg.PLAIN_CALLS)
    out = cg.accel_jerk_rows(_t(r32), _t(vr32), _t(s32), _t(sv32), _t(m32),
                             eps, G, 0, eps == 0.0)
    assert cg.PLAIN_CALLS["rows_jerk_stream"] == \
        plain["rows_jerk_stream"] + 1
    assert tuple(out[0].shape) == tuple(out[1].shape) == (nr, 3)
    args = (r32, vr32, s32, sv32, m32, np.float32(eps), np.float32(G))
    refs = [pg.accel_jerk_rows_streamed(*args, guarded=eps == 0.0,
                                        compensated=True),
            pg.accel_jerk_rows(*args, guarded=eps == 0.0),
            jgrav.accel_jerk_rows(rows, vrows, src, svel, mass, eps, G)]
    for ref in refs:
        _close([out[0]], [ref[0]], 5e-6)
        _close([out[1]], [ref[1]], 1e-5)


def test_c6_kdk_steps_through_the_chunked_route_match_jax(monkeypatch):
    """c6 (Plummer on the circular 8 kpc orbit, KDK at dt = 1/256) at n =
    300 with STREAM_N lowered to 256 and chunk 128: eight steps through the
    port's chunked route (K2's and K12's twins) against the JAX package's
    steps (its jnp backend) from the same IC. Positions agree to 1e-9 of
    the cluster's size: the f32 force differs by summation order only, and
    eight steps of dt^2 turn 5e-6 of max|a| into far less."""
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(cg, "CHUNK_SYM", CHUNK)
    n, steps = 300, 8
    over = [f"ic.n={n}"]
    cfg_j = jconfig.apply_overrides(jconfig.load_config(C6), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(C6), over)
    pos, vel, mass, ids = numpy_plummer(n, seed=6)
    us = jscene.build_units(cfg_j)
    ext = jscene.build_external_potential(cfg_j, us)
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext,
                                  cfg_j, us)
    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=ext, backend="jnp")
    stepper, kind = jscene.make_stepper(cfg_j, force)
    carry = jax.jit(stepper.advance, static_argnums=1)(stepper.init(state),
                                                       steps)
    tus = tscene.build_units(cfg_t)
    text = tscene.build_external_potential(cfg_t, tus)
    tstate = tscene.place_on_orbit(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), text, cfg_t, tus)
    tforce = t_make_force_model(cfg_t.integrator.eps, tus.G, text)
    tstepper, tkind = tscene.make_stepper(cfg_t, tforce)
    assert kind == tkind == "kdk"
    plain = dict(cg.PLAIN_CALLS)
    tcarry = tstepper.advance(tstepper.init(tstate), steps)
    assert cg.PLAIN_CALLS["cross"] == plain["cross"] + 3 * (steps + 1)
    assert cg.PLAIN_CALLS["rows"] == plain["rows"]
    size = float(np.abs(pos - pos.mean(axis=0)).max())
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(carry.state.pos), rtol=0,
                               atol=1e-9 * size)
    assert tcarry.state.time == pytest.approx(float(carry.state.time),
                                              rel=1e-15)


def test_capped_tiers_are_refused_before_any_stepper(monkeypatch, capsys):
    """With STREAM_N lowered to 256: ``info`` and ``run`` refuse a df32
    config past it (counting a binary population's extra stars) with
    NotImplementedError from check_supported, before any IC or stepper is
    built, and name the ROADMAP item (B10); the f32 and the extended config
    are accepted, and ``info`` names each one's chunked route at its N."""
    monkeypatch.setattr(cg, "STREAM_N", 256)

    def built(*args, **kw):
        raise AssertionError("a refused config built its IC or stepper")

    monkeypatch.setattr(tscene, "build_ic", built)
    monkeypatch.setattr(tscene, "make_stepper", built)
    over = ["--set", "ic.n=300", "--set", "integrator.precision=df32"]
    assert tmain.main(["info", C6, *over]) == 0
    assert "does not run here: 300 particles at the df32" \
        in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="B10"):
        tmain.main(["run", C6, "--device", "cpu", *over])
    # 200 systems, 30% binaries: 260 stars, past 256
    binaries = ["--set", "ic.n=200", "--set", "ic.binary_fraction=0.3",
                "--set", "ic.binary_a_min=0.01", "--set",
                "ic.binary_a_max=0.02", "--set", "integrator.precision=df32"]
    with pytest.raises(NotImplementedError, match="260 particles"):
        tmain.main(["run", C6, "--device", "cpu", *binaries])
    monkeypatch.undo()
    monkeypatch.setattr(cg, "STREAM_N", 256)
    assert tmain.main(["info", C6, "--set", "ic.n=300"]) == 0
    out = capsys.readouterr().out
    assert "stepper: kdk LeapfrogKDK" in out
    assert ("kernels on the card at N = 300: accel and potential: chunked "
            "pair-symmetric: K2 on 1 diagonal chunks") in out
    assert tmain.main(["info", C6]) == 0
    assert ("K2 on 8 diagonal chunks of up to 131072, K12 on 28 chunk pairs"
            in capsys.readouterr().out)
    ext = ["--set", "integrator.precision=extended"]
    assert tmain.main(["info", C6, "--set", "ic.n=300", *ext]) == 0
    out = capsys.readouterr().out
    assert "stepper: kdk LeapfrogKDK" in out
    assert ("kernels on the card at N = 300: accel and potential: chunked "
            "pair-symmetric: K6 on 1 diagonal chunks of up to 98304, K15 on "
            "0 chunk pairs") in out
    assert "pairwise precision tier: extended" in out
    assert tmain.main(["info", C6, *ext]) == 0
    assert ("K6 on 11 diagonal chunks of up to 98304, K15 on 55 chunk pairs"
            in capsys.readouterr().out)
    c4 = f"{REPO}/configs/c4_block_32k_eccentric.toml"
    assert tmain.main(["info", c4, "--set", "ic.n=1048576", *ext]) == 0
    assert ("accel + jerk: chunked pair-symmetric: K7 on 15 diagonal chunks "
            "of up to 73728, K16 on 105 chunk pairs; potential: chunked "
            "pair-symmetric: K6 on 11 diagonal chunks of up to 98304, K15 on "
            "55 chunk pairs; active rows: K17 (compensated, any row count)"
            in capsys.readouterr().out)


class _FakeLibrary:
    """The kernel library's scratch-size exports with made-up geometries
    (``sym`` for K2, ``cross`` for K12, K6's size made from ``sym`` and
    K15's, K13's and K16's from ``cross``, each its own), so that the
    sizing of the chunked evaluation's one scratch buffer is checked
    without a card."""

    def __init__(self, sym, cross):
        self.sym, self.cross = sym, cross

    def ocn_sym_scratch(self, n, geom):
        assert geom == 0
        return self.sym(n)

    def ocn_sym_x_scratch(self, n, geom):
        assert geom == 0
        return 11 * self.sym(n) + 4

    def ocn_sym_tile(self):
        return 128

    def ocn_cross_accel_scratch(self, nA, nB, geom):
        assert geom == 0
        return self.cross(nA, nB)

    def ocn_cross_x_scratch(self, nA, nB, geom):
        assert geom == 0
        return 3 * self.cross(nA, nB) + 1

    def ocn_cross_jerk_scratch(self, nA, nB, geom):
        assert geom == 0
        return 5 * self.cross(nA, nB) + 2

    def ocn_cross_jerk_x_scratch(self, nA, nB, geom):
        assert geom == 0
        return 7 * self.cross(nA, nB) + 3


# each makes another launch the largest: a full chunk pair, a full
# diagonal chunk, the ragged last diagonal chunk, the ragged chunk pair
_FAKES = {
    "cross": _FakeLibrary(lambda n: n, lambda nA, nB: nA * nB),
    "diag": _FakeLibrary(lambda n: 1000 * n, lambda nA, nB: nA + nB),
    "ragged_diag": _FakeLibrary(lambda n: 10 ** 7 if n % CHUNK else n,
                                lambda nA, nB: nA * nB),
    "ragged_cross": _FakeLibrary(
        lambda n: n, lambda nA, nB: 10 ** 7 if nB % CHUNK else nA * nB),
}


@pytest.mark.parametrize("n", [100, 300, 384])
@pytest.mark.parametrize("jerk", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fake", sorted(_FAKES))
def test_chunk_scratch_covers_every_launch(monkeypatch, fake, extended, jerk,
                                           n):
    """The chunked evaluation's one scratch buffer holds what the largest of
    its launches needs, as each kernel's own size function says: every
    diagonal chunk (K2, K3, K6 or K7) and every chunk pair (K12, K13, K15 or
    K16) of ``_chunked_sum``'s order at chunk 128, for one chunk (n = 100),
    a ragged last chunk (300) and whole chunks (384), with the sizes of the
    register-blocked kernels K2, K6, K12, K13, K15 and K16 made up so that
    each kind of launch is the largest in turn."""
    monkeypatch.setattr(cg, "_library", lambda: _FAKES[fake])
    diag = "sym" + ("_jerk" if jerk else "") + ("_x" if extended else "")
    cross = diag.replace("sym", "cross")
    bounds = [(k, min(k + CHUNK, n)) for k in range(0, n, CHUNK)]
    needs = [cg.sym_scratch_floats(k1 - k0, diag) for k0, k1 in bounds]
    needs += [cg.cross_scratch_floats(i1 - i0, j1 - j0, cross)
              for a, (i0, i1) in enumerate(bounds)
              for j0, j1 in bounds[a + 1:]]
    assert cg.chunk_scratch_floats(n, CHUNK, jerk, extended) == max(needs)
    assert cg._chunk_scratch(n, CHUNK, jerk, extended, "cpu").numel() == \
        max(needs)


@pytest.mark.parametrize("kernel,want", [
    ("sym", 7 * 300), ("sym_jerk", 3 * 3 * 128 * 6),
    ("sym_x", 11 * 7 * 300 + 4), ("sym_jerk_x", 3 * 3 * 128 * 6)])
def test_sym_scratch_asks_each_kernel(monkeypatch, kernel, want):
    """K2's and K6's scratch each come from the kernel's own export; K3 and
    K7 keep the shared 128-tile layout (nt x nt x 128 slots of 6 floats);
    an unknown kernel is refused."""
    monkeypatch.setattr(cg, "_library", lambda: _FakeLibrary(
        lambda n: 7 * n, lambda nA, nB: 0))
    assert cg.sym_scratch_floats(300, kernel) == want
    with pytest.raises(ValueError, match="no pair-symmetric kernel"):
        cg.sym_scratch_floats(300, "cross")


@pytest.mark.parametrize("kernel,want", [
    ("cross", 300 * 200), ("cross_x", 3 * 300 * 200 + 1),
    ("cross_jerk", 5 * 300 * 200 + 2), ("cross_jerk_x", 7 * 300 * 200 + 3)])
def test_cross_scratch_asks_each_kernel(monkeypatch, kernel, want):
    """K12's, K15's, K13's and K16's scratch each come from the kernel's own
    export (their geometries differ); an unknown kernel is refused."""
    monkeypatch.setattr(cg, "_library", lambda: _FAKES["cross"])
    assert cg.cross_scratch_floats(300, 200, kernel) == want
    with pytest.raises(ValueError, match="no cross kernel"):
        cg.cross_scratch_floats(300, 200, "sym")


def test_geometries_are_checked_before_any_launch(monkeypatch):
    """The ten compiled (R, S) of the register-blocked kernels K2, K6, K12,
    K15, K13 and K16 encode as the library takes them; None leaves the
    choice to the sizes, anything else is refused; the geometry queries
    name a register-blocked kernel (K15 and K6 have one now, K3 and K7
    none) and ask that kernel's own export."""
    assert len(cg.GEOMETRIES) == 10
    assert cg._geom(None) == 0
    assert [cg._geom(g) for g in cg.GEOMETRIES] == [
        0x11, 0x21, 0x22, 0x41, 0x42, 0x44, 0x81, 0x82, 0x84, 0x88]
    for bad in ((3, 1), (2, 4), (16, 1)):
        with pytest.raises(ValueError, match="geometry must be one of"):
            cg._geom(bad)
    asked = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *sizes: asked.append((name, sizes)) or 0x82

    monkeypatch.setattr(cg, "_library", lambda: _Lib())
    assert cg.cross_geometry(300, 200, "cross_x") == (8, 2)
    assert cg.sym_geometry(300, "sym_x") == (8, 2)
    assert cg.sym_geometry(300) == (8, 2)
    assert asked == [("ocn_cross_x_geometry", (300, 200)),
                     ("ocn_sym_x_geometry", (300,)),
                     ("ocn_sym_geometry", (300,))]
    with pytest.raises(ValueError, match="no register-blocked cross kernel"):
        cg.cross_geometry(300, 200, "sym")
    for kernel in ("sym_jerk", "sym_jerk_x"):
        with pytest.raises(ValueError,
                           match="no register-blocked pair-symmetric kernel"):
            cg.sym_geometry(300, kernel)


@pytest.mark.parametrize("kernel", ["cross", "cross_x", "cross_jerk",
                                    "cross_jerk_x"])
def test_cross_scratch_passes_each_geometry(monkeypatch, kernel):
    """K12's, K15's, K13's and K16's scratch queries carry the geometry as
    the library takes it (0 for the kernel's own), and refuse one not
    compiled before the library is asked."""
    asked = []

    class _Lib:
        def __getattr__(self, name):
            return lambda nA, nB, geom: asked.append((name, geom)) or 1

    monkeypatch.setattr(cg, "_library", lambda: _Lib())
    for g in (None, *cg.GEOMETRIES):
        cg.cross_scratch_floats(300, 200, kernel, g)
    export = {"cross": "ocn_cross_accel_scratch",
              "cross_x": "ocn_cross_x_scratch",
              "cross_jerk": "ocn_cross_jerk_scratch",
              "cross_jerk_x": "ocn_cross_jerk_x_scratch"}[kernel]
    assert asked == [(export, 0)] + [(export, r * 16 + s)
                                     for r, s in cg.GEOMETRIES]
    with pytest.raises(ValueError, match="geometry must be one of"):
        cg.cross_scratch_floats(300, 200, kernel, (3, 3))


@pytest.mark.parametrize("kernel", ["sym", "sym_x"])
def test_sym_scratch_passes_each_geometry(monkeypatch, kernel):
    """K2's and K6's scratch queries carry the geometry as the library
    takes it (0 for the kernel's own), and refuse one not compiled before
    the library is asked."""
    asked = []

    class _Lib:
        def __getattr__(self, name):
            return lambda n, geom: asked.append((name, n, geom)) or 1

    monkeypatch.setattr(cg, "_library", lambda: _Lib())
    for g in (None, *cg.GEOMETRIES):
        cg.sym_scratch_floats(300, kernel, g)
    export = {"sym": "ocn_sym_scratch", "sym_x": "ocn_sym_x_scratch"}[kernel]
    assert asked == [(export, 300, 0)] + [(export, 300, r * 16 + s)
                                          for r, s in cg.GEOMETRIES]
    with pytest.raises(ValueError, match="geometry must be one of"):
        cg.sym_scratch_floats(300, kernel, (3, 3))
