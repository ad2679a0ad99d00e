"""The extended (hi/lo) precision tier of the port against the JAX package
on identical seeded numpy inputs.

On the CPU the port's dispatchers (``ops/cuda_gravity.py``: ``accel_x``,
``accel_potential_x``, ``accel_jerk_x``, ``accel_jerk_rows_x``, the three
``*_rows_x_hilo`` and the three ``*_sym_x``) run the plain twins of kernels
K6-K9 (``ops/df32.py``). Each is held to the JAX function of the same name,
whose Pallas kernel (#10 _accel_kernel_x, #11 _accel_phi_kernel_x, #12
_accel_jerk_kernel_x, #19 _make_sym_kernel with _OP_AX/_OP_PX/_OP_JX) runs
in interpret mode as tests/unit/test_pallas_tiers.py and
test_pallas_interpret.py run it (sym tiles lowered to 64 on the test's
side), to the JAX package's jnp tier (``oc_nbody_tpu/ops/df32.py``) and to
the f64 oracle.

Tolerances. Against the f64 oracle the JAX package's own bounds
(test_pallas_tiers.py:51,96,108): 2e-5·max|a|, 5e-5·max|j|, phi
5e-6·max|phi| (the softened self term, included then cancelled, bounds phi
at f32 rounding of G m/eps). Between the port and JAX on a smooth cluster:
5e-6·max|a| and 1e-5·max|j|, 5e-6·max|phi| (both are f32 sums of the same
pair terms in different orders; rsqrt differs and is Newton-refined in
both). The hi/lo split itself is bitwise equal.

A kernel that ignored ``lo`` would pass all of that on a smooth cluster, so
the close-pair case of test_pallas_tiers.py:32-41 (50 pairs at 1e-5 of the
coordinate scale, eps = 1e-4) asserts both sides: the extended tier inside
its bound, the f32 tier outside 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu.ops import df32 as jdf32
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.ops.pallas_pair import _prep_x_T, _split_rows
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import df32 as tdf32
from oc_nbody_tpu_torch.ops import gravity as tgrav

G = 1.3
EPS = 0.05
_PALLAS = (pg.accel_x, pg.accel_potential_x, pg.accel_jerk_rows_x,
           pg.accel_rows_x_hilo, pg.accel_potential_rows_x_hilo,
           pg.accel_jerk_rows_x_hilo, pg.accel_sym_x,
           pg.accel_potential_sym_x, pg.accel_jerk_sym_x)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    # several tiles at these small N (the production tiles are 384 and 256)
    for name in ("T_SYMX", "T_SYMXP", "T_SYMXJ"):
        monkeypatch.setattr(pg, name, 64)
    for fn in _PALLAS:
        fn.clear_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    for fn in _PALLAS:
        fn.clear_cache()


def _cluster(n, seed, offset=(0.0, 0.0, 0.0)):
    """(pos, vel, mass) f64: a smooth normal cluster, unequal masses."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) + np.asarray(offset)
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _close_pairs(n=600, seed=7):
    """The JAX package's close-pair case, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos[50:100] = pos[:50] + 1e-5 * rng.normal(size=(50, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _split_np(pos, vel, mass, center=None, vcenter=None):
    """numpy (hi, lo, vhi, vlo, gm) planes under one centring."""
    c = pos.mean(axis=0) if center is None else center
    vc = vel.mean(axis=0) if vcenter is None else vcenter
    out = []
    for x in (pos - c, vel - vc):
        hi = x.astype(np.float32)
        out += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    return (*out, (G * mass).astype(np.float32))


def _rel(got, want, vector=True):
    """max row error over max row size (norms for vectors)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vector:
        return (np.linalg.norm(got - want, axis=1).max()
                / np.linalg.norm(want, axis=1).max())
    return np.abs(got - want).max() / np.abs(want).max()


# ---- (a) operand preparation ----------------------------------------------

def test_split_hilo_is_bitwise_split_rows():
    pos, _, _ = _cluster(257, 1, offset=(8000.0, -3.0, 0.5))
    center = pos.mean(axis=0)
    jhi, jlo = _split_rows(jnp.asarray(pos), jnp.asarray(center))
    hi, lo = tgrav.split_hilo(torch.from_numpy(pos - center))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    # hi + lo holds the centred f64 value to ~2^-48 of the scale
    back = hi.double() + lo.double()
    assert float((back - torch.from_numpy(pos - center)).abs().max()) \
        < 2.0 ** -46 * np.abs(pos - center).max()


@pytest.mark.parametrize("with_vel", [False, True])
def test_prepare_x_is_bitwise_prep_x_T(with_vel):
    """On a 2^-20 grid with N a power of two both packages' means are exact
    sums, so one centring gives bitwise equal planes and gm."""
    n = 256
    pos, vel, mass = _cluster(n, 2, offset=(8000.0, 0.0, -20.0))
    pos, vel = (np.round(x * 2.0 ** 20) / 2.0 ** 20 for x in (pos, vel))
    planes, gm = _prep_x_T(jnp.asarray(pos), jnp.asarray(mass), G, 384,
                           vel=jnp.asarray(vel) if with_vel else None)
    tp, tv, tm = _t(pos, vel, mass)
    out = tgrav.prepare_x(tp, tm, G, vel=tv if with_vel else None)
    order = (0, 1, 3, 4) if with_vel else (0, 1)
    for k, plane in zip(order, planes):
        assert plane.shape == (3, 384)
        np.testing.assert_array_equal(out[k].numpy(),
                                      np.asarray(plane)[:, :n].T)
        assert out[k].is_contiguous() and out[k].dtype == torch.float32
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(gm)[0, :n])
    # f32 mass, as the state holds it: still G·m formed in f64
    gm32 = tgrav.gm_f32(tm.float(), G)
    np.testing.assert_array_equal(
        gm32.numpy(), (G * mass.astype(np.float32).astype(np.float64)
                       ).astype(np.float32))


# ---- (b) every dispatcher against JAX, the jnp tier and the f64 oracle ----

def _self_cases():
    """name -> (port fn, JAX Pallas fn, JAX jnp-tier fn, kind)."""
    return {
        "accel_x": (cg.accel_x, pg.accel_x, jdf32.accel_extended, "a"),
        "accel_potential_x": (cg.accel_potential_x, pg.accel_potential_x,
                              jdf32.accel_potential_extended, "p"),
        "accel_jerk_x": (cg.accel_jerk_x, pg.accel_jerk_x,
                         jdf32.accel_jerk_extended, "j"),
        "accel_sym_x": (cg.accel_sym_x, pg.accel_sym_x,
                        jdf32.accel_extended, "a"),
        "accel_potential_sym_x": (cg.accel_potential_sym_x,
                                  pg.accel_potential_sym_x,
                                  jdf32.accel_potential_extended, "p"),
        "accel_jerk_sym_x": (cg.accel_jerk_sym_x, pg.accel_jerk_sym_x,
                             jdf32.accel_jerk_extended, "j"),
    }


def _check_outputs(kind, got, jax_out, tier_out, oracle, mass, eps):
    """got/jax_out/tier_out: acc, (acc, raw phi) or (acc, jerk); oracle the
    f64 (acc, phi with the self term removed, jerk)."""
    as_tuple = lambda o: tuple(o) if isinstance(o, (tuple, list)) else (o,)
    got, jax_out, tier_out = map(as_tuple, (got, jax_out, tier_out))
    assert all(g.dtype == torch.float64 for g in got)
    a_ref, phi_ref, j_ref = oracle
    for other in (jax_out, tier_out):
        assert _rel(got[0], other[0]) < 5e-6
    assert _rel(got[0], a_ref) < 2e-5
    if kind == "p":
        for other in (jax_out, tier_out):
            assert _rel(got[1], other[1], vector=False) < 5e-6
        # raw phi: adding self_phi lands on the finished oracle phi
        phi = got[1].numpy() + G * mass / eps if eps > 0 else got[1].numpy()
        assert _rel(phi, phi_ref, vector=False) < 5e-6
    if kind == "j":
        for other in (jax_out, tier_out):
            assert _rel(got[1], other[1]) < 1e-5
        assert _rel(got[1], j_ref) < 5e-5


@pytest.mark.parametrize("name", list(_self_cases()))
def test_self_interaction_dispatcher_matches_jax(name):
    fn, jfn, tier_fn, kind = _self_cases()[name]
    n = 300 if "sym" in name else 333
    pos, vel, mass = _cluster(n, 11, offset=(8000.0, 0.0, 3.0))
    tp, tv, tm = _t(pos, vel, mass)
    jp, jv, jm = map(jnp.asarray, (pos, vel, mass))
    a_ref, phi_ref = jgrav.accel_potential_direct(jp, jm, EPS, G)
    _, j_ref = jgrav.accel_jerk_direct(jp, jv, jm, EPS, G)
    plain = dict(cg.PLAIN_CALLS)
    if kind == "j":
        got = fn(tp, tv, tm, EPS, G)
        jax_out = jfn(jp, jv, jm, EPS, G)
        tier_out = tier_fn(jp, jv, jm, EPS, G, chunk=64)
    else:
        got = fn(tp, tm, EPS, G)
        jax_out = jfn(jp, jm, EPS, G)
        tier_out = tier_fn(jp, jm, EPS, G, chunk=64)
    _check_outputs(kind, got, jax_out, tier_out, (a_ref, phi_ref, j_ref),
                   mass, EPS)
    # on CPU tensors exactly one plain twin ran, the one of its kernel
    ran = {k for k in plain if cg.PLAIN_CALLS[k] != plain[k]}
    want = {"a": "x", "p": "x", "j": "jerk_x"}[kind]
    assert ran == {("sym_" if "sym" in name else "rows_") + want}


@pytest.mark.parametrize("kind", ["a", "p", "j"])
def test_df32_module_matches_jax_tier(kind):
    """The port's ``ops/df32.py`` f64-in/out functions against the JAX
    package's (both plain array code: f32 summation order apart)."""
    pos, vel, mass = _cluster(200, 29, offset=(0.0, 8000.0, 0.0))
    tp, tv, tm = _t(pos, vel, mass)
    jp, jv, jm = map(jnp.asarray, (pos, vel, mass))
    if kind == "j":
        got = tdf32.accel_jerk_extended(tp, tv, tm, EPS, G, chunk=64)
        want = jdf32.accel_jerk_extended(jp, jv, jm, EPS, G, chunk=64)
    else:
        name = "accel_extended" if kind == "a" else "accel_potential_extended"
        got = getattr(tdf32, name)(tp, tm, EPS, G, chunk=64)
        want = getattr(jdf32, name)(jp, jm, EPS, G, chunk=64)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(g.dtype == torch.float64 for g in got)
    assert _rel(got[0], want[0]) < 5e-6
    if kind == "p":
        assert _rel(got[1], want[1], vector=False) < 5e-6
    if kind == "j":
        assert _rel(got[1], want[1]) < 1e-5


@pytest.mark.parametrize("eps", [EPS, 0.0])
@pytest.mark.parametrize("kind", ["a", "p", "j"])
def test_rows_x_hilo_matches_jax(kind, eps):
    """The three pre-split forms, rows a subset of the sources (so eps = 0
    meets its coincident self pairs), against the Pallas kernels, JAX's jnp
    tier, the port's df32 module in f32 and in f64, and the f64 oracle."""
    pos, vel, mass = _cluster(313, 13, offset=(-500.0, 20.0, 0.0))
    rows = np.arange(0, 313, 4)
    center, vcenter = pos.mean(axis=0), vel.mean(axis=0)
    shi, slo, svhi, svlo, gm = _split_np(pos, vel, mass)
    rhi, rlo, vhi, vlo, _ = _split_np(pos[rows], vel[rows], mass[rows],
                                      center, vcenter)
    if kind == "j":
        planes = (rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm)
        fn, jfn, jtier, ttier = (cg.accel_jerk_rows_x_hilo,
                                 pg.accel_jerk_rows_x_hilo,
                                 jdf32.accel_jerk_rows_x_hilo,
                                 tdf32.accel_jerk_rows_x_hilo)
    else:
        planes = (rhi, rlo, shi, slo, gm)
        fn, jfn, jtier, ttier = (
            (cg.accel_rows_x_hilo, pg.accel_rows_x_hilo,
             jdf32.accel_rows_x_hilo, tdf32.accel_rows_x_hilo) if kind == "a"
            else (cg.accel_potential_rows_x_hilo,
                  pg.accel_potential_rows_x_hilo,
                  jdf32.accel_potential_rows_x_hilo,
                  tdf32.accel_potential_rows_x_hilo))
    as_tuple = lambda o: tuple(o) if isinstance(o, (tuple, list)) else (o,)
    guarded = eps == 0.0
    got = as_tuple(fn(*_t(*planes), eps, guarded=guarded))
    assert all(g.dtype == torch.float32 for g in got)
    jax_out = as_tuple(jfn(*map(jnp.asarray, planes), eps, guarded=guarded))
    tier_out = as_tuple(jtier(*map(jnp.asarray, planes), eps, chunk=64))
    f64_out = as_tuple(ttier(*_t(*planes), eps, dtype=torch.float64,
                             guarded=guarded))
    assert all(o.dtype == torch.float64 for o in f64_out)
    jp, jv, jm = map(jnp.asarray, (pos, vel, mass))
    a_ref, phi_ref = jgrav.accel_potential_rows(jp[rows], jp, jm, eps, G,
                                                chunk=128)
    _, j_ref = jgrav.accel_jerk_rows(jp[rows], jv[rows], jp, jv, jm, eps, G,
                                     128)
    for other in (jax_out, tier_out):
        assert _rel(got[0], other[0]) < 5e-6
    # the f64 evaluation of the same planes is the f64 oracle up to the one
    # f32 rounding the planes hold, gm = fl32(G m) (2^-24 relative)
    assert _rel(f64_out[0], a_ref) < 1e-7
    assert _rel(got[0], a_ref) < 2e-5
    if kind == "p":
        # raw potentials on both sides (the rows' self terms included)
        for other in (jax_out, tier_out):
            assert _rel(got[1], other[1], vector=False) < 5e-6
        assert _rel(f64_out[1], phi_ref, vector=False) < 1e-7
        assert _rel(got[1], phi_ref, vector=False) < 5e-6
    if kind == "j":
        for other in (jax_out, tier_out):
            assert _rel(got[1], other[1]) < 1e-5
        assert _rel(f64_out[1], j_ref) < 1e-7
        assert _rel(got[1], j_ref) < 5e-5


def test_accel_jerk_rows_x_centres_on_the_source_means():
    """Rows far from the sources' centre of figure, the whole set 8 kpc out
    and moving: one centring, on the SOURCE means, for rows and sources."""
    pos, vel, mass = _cluster(320, 17, offset=(8000.0, 0.0, 0.0))
    vel = vel + np.array([0.0, 220.0, 0.0])
    rows = np.arange(5, 125)
    args = (pos[rows], vel[rows], pos, vel, mass)
    got = cg.accel_jerk_rows_x(*_t(*args), EPS, G)
    want = pg.accel_jerk_rows_x(*map(jnp.asarray, args), EPS, G)
    a_ref, j_ref = jgrav.accel_jerk_rows(*map(jnp.asarray, args), EPS, G, 128)
    assert got[0].dtype == got[1].dtype == torch.float64
    assert _rel(got[0], want[0]) < 5e-6 and _rel(got[1], want[1]) < 1e-5
    assert _rel(got[0], a_ref) < 2e-5 and _rel(got[1], j_ref) < 5e-5
    # the rows' planes are the gather of the sources' planes, bit for bit
    tp, tv = _t(pos, vel)
    shi, slo, center = tgrav.centre_split(tp)
    svhi, svlo, vcenter = tgrav.centre_split(tv)
    split = cg.split_rows_x(tp[rows], tv[rows], center, vcenter)
    for mine, src in zip(split, (shi, slo, svhi, svlo)):
        assert torch.equal(mine, src[rows])


# ---- (c) close pairs: the case that tells the tiers apart ------------------

def test_close_pairs_extended_inside_f32_outside():
    pos, vel, mass = _close_pairs()
    eps = 1e-4
    tp, tv, tm = _t(pos, vel, mass)
    a_ref, phi_ref = tgrav.accel_potential_direct(tp, tm, eps, G)
    _, j_ref = tgrav.accel_jerk_direct(tp, tv, tm, eps, G)
    # the f32 tier loses the close pairs' separations
    a32, j32 = cg.accel_jerk(tp, tv, tm, eps, G)
    assert _rel(a32, a_ref) > 1e-3
    # (the f32 jerk errs by 3.4e-4 of max|j| here: max|j| is itself set by
    # the closest pair, so its bound is set between the two tiers)
    assert _rel(j32, j_ref) > 2e-4
    assert _rel(cg.accel(tp, tm, eps, G), a_ref) > 1e-3
    # the extended tier keeps them
    ax = cg.accel_x(tp, tm, eps, G)
    axp, phi = cg.accel_potential_x(tp, tm, eps, G)
    axj, jx = cg.accel_jerk_x(tp, tv, tm, eps, G)
    for a in (ax, axp, axj):
        assert _rel(a, a_ref) < 2e-5
    assert _rel(jx, j_ref) < 5e-5
    phi = phi + tgrav.self_phi(tm, eps, G)
    assert _rel(phi, phi_ref, vector=False) < 5e-6
    # and so do the pair-symmetric forms
    assert _rel(cg.accel_sym_x(tp, tm, eps, G), a_ref) < 2e-5
    a_s, j_s = cg.accel_jerk_sym_x(tp, tv, tm, eps, G)
    assert _rel(a_s, a_ref) < 2e-5 and _rel(j_s, j_ref) < 5e-5
    # a tier that dropped lo would be the f32 tier: zero lo planes miss
    hi, lo, gm = tgrav.prepare_x(tp, tm, G)
    no_lo = cg.accel_rows_x_hilo(hi, torch.zeros_like(lo), hi,
                                 torch.zeros_like(lo), gm, eps)
    assert _rel(no_lo, a_ref) > 1e-3
    # the same within the JAX package's own bound, through its kernel
    assert _rel(pg.accel_x(jnp.asarray(pos), jnp.asarray(mass), eps, G),
                a_ref) < 2e-5


def test_coincident_pair_at_eps_zero_adds_nothing():
    """u rounds to <= 0 for a coincident pair with eps = 0: the guard gives
    inv = 0 and the Newton step leaves 0."""
    pos = np.zeros((3, 3))
    pos[2] = [1.0, 0.0, 0.0]
    vel = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 0]])
    mass = np.ones(3)
    tp, tv, tm = _t(pos, vel, mass)
    for acc, jerk in (cg.accel_jerk_x(tp, tv, tm, 0.0),
                      cg.accel_jerk_sym_x(tp, tv, tm, 0.0)):
        assert bool(acc.isfinite().all()) and bool(jerk.isfinite().all())
        want, _ = tgrav.accel_jerk_direct(tp, tv, tm, 0.0)
        torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-6)
    acc, phi = cg.accel_potential_x(tp, tm, 0.0)
    assert bool(phi.isfinite().all())
    torch.testing.assert_close(phi, torch.tensor([-1.0, -1.0, -2.0],
                                                 dtype=torch.float64))


# ---- (d) dispatch thresholds -----------------------------------------------

def _ran(before):
    return {k for k in before if cg.PLAIN_CALLS[k] != before[k]}


def test_dispatch_thresholds(monkeypatch):
    """All three extended self-interaction forms switch to the
    pair-symmetric kernel at SYM_MIN, the jerk too (the f32 jerk switches at
    RT_MIN_JERK), and past STREAM_N to the chunked route (K6/K7's twins on
    the diagonal chunks, K15/K16's on the chunk pairs); rows past STREAM_N
    sources or RT_MAX_ROWS rows take K17's twin for the jerk and K19's for
    the rows accel forms (escape pruning's). Thresholds lowered, not N
    raised."""
    monkeypatch.setattr(cg, "SYM_MIN", 64)
    monkeypatch.setattr(cg, "RT_MIN_JERK", 128)
    pos, vel, mass = _cluster(200, 19)
    tp, tv, tm = _t(pos, vel, mass)
    for n, want_x, want_f32 in ((63, "rows", "rows_jerk"),
                                (64, "sym", "rows_jerk"),
                                (128, "sym", "sym_jerk")):
        args = (tp[:n], tv[:n], tm[:n])
        before = dict(cg.PLAIN_CALLS)
        cg.accel_jerk_x(*args, EPS)
        assert _ran(before) == {want_x + "_jerk_x"}
        before = dict(cg.PLAIN_CALLS)
        cg.accel_x(args[0], args[2], EPS)
        cg.accel_potential_x(args[0], args[2], EPS)
        assert _ran(before) == {want_x + "_x"}
        before = dict(cg.PLAIN_CALLS)
        cg.accel_jerk(*args, EPS)
        assert _ran(before) == {want_f32}
    assert pg.SYM_MIN == 8192 and pg.RT_MIN_JERK == 16384  # JAX's values
    monkeypatch.undo()
    assert cg.SYM_MIN == pg.SYM_MIN and cg.STREAM_N == pg.STREAM_N
    assert cg.RT_MAX_ROWS == pg.RT_MAX_ROWS == 65536

    monkeypatch.setattr(cg, "STREAM_N", 128)
    monkeypatch.setattr(cg, "CHUNK_SYMX", 64)
    monkeypatch.setattr(cg, "CHUNK_SYMXJ", 64)
    for calls, want in (
            ((lambda: cg.accel_x(tp, tm, EPS),
              lambda: cg.accel_potential_x(tp, tm, EPS)),
             {"sym_x", "cross_x"}),
            ((lambda: cg.accel_jerk_x(tp, tv, tm, EPS),),
             {"sym_jerk_x", "cross_jerk_x"}),
            ((lambda: cg.accel_jerk_rows_x(tp[:4], tv[:4], tp, tv, tm, EPS),),
             {"rows_jerk_x_stream"})):
        before = dict(cg.PLAIN_CALLS)
        for call in calls:
            call()
        assert _ran(before) == want
    before = dict(cg.PLAIN_CALLS)
    cg.accel_x(tp[:128], tm[:128], EPS)     # at STREAM_N: resident
    assert _ran(before) == {"rows_x"}
    monkeypatch.setattr(cg, "STREAM_N", 262144)
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 16)
    hi, lo, gm = tgrav.prepare_x(tp, tm, 1.0)
    for nr, want in ((16, {"rows_x"}), (17, {"rows_x_stream"})):
        before = dict(cg.PLAIN_CALLS)
        cg.accel_rows_x_hilo(hi[:nr].contiguous(), lo[:nr].contiguous(), hi,
                             lo, gm, EPS)
        cg.accel_potential_rows_x_hilo(hi[:nr].contiguous(),
                                       lo[:nr].contiguous(), hi, lo, gm, EPS)
        assert _ran(before) == want
    for nr, want in ((16, {"rows_jerk_x"}), (17, {"rows_jerk_x_stream"})):
        before = dict(cg.PLAIN_CALLS)
        cg.accel_jerk_rows_x(tp[:nr], tv[:nr], tp, tv, tm, EPS)
        assert _ran(before) == want
    # the row cap is the rows forms' alone: a pair-symmetric
    # self-interaction of more particles than RT_MAX_ROWS runs (c5x's
    # 131,072 against 65,536)
    monkeypatch.setattr(cg, "SYM_MIN", 64)
    before = dict(cg.PLAIN_CALLS)
    cg.accel_x(tp, tm, EPS)
    cg.accel_potential_x(tp, tm, EPS)
    cg.accel_jerk_x(tp, tv, tm, EPS)
    assert _ran(before) == {"sym_x", "sym_jerk_x"}


def test_wrappers_refuse_mixed_devices_and_count_only_plain_on_cpu():
    pos, vel, mass = _cluster(40, 23)
    tp, tv, tm = _t(pos, vel, mass)
    launches = dict(cg.LAUNCHES)
    cg.accel_x(tp, tm, EPS)
    cg.accel_jerk_x(tp, tv, tm, EPS)
    assert cg.LAUNCHES == launches        # no kernel on CPU tensors
    assert set(cg.LAUNCHES) == set(cg.PLAIN_CALLS) and len(cg.LAUNCHES) == 25
    hi, lo, gm = tgrav.prepare_x(tp, tm, 1.0)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        cg.accel_rows_x_hilo(hi, lo, hi.to("meta"), lo, gm, EPS)
