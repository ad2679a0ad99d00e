"""The two-float (df32) precision tier of the port against the JAX package,
on the CPU (no GPU, no triton): the plain twins of K10 and K11
(``oc_nbody_tpu_torch/ops/df32.py``, reached through ``ops/cuda_df.py``),
the force model's df32 routes, and the tier end to end.

  * the twins' error-free transforms are exact in f64 (s + e == a + b,
    p + e == a·b) and ``df_rsqrt`` is inside 1e-13;
  * ``accel_df`` / ``accel_potential_df`` / ``accel_jerk_df`` against the
    JAX functions of the same names on the same numpy inputs (400 particles,
    50 of them 1e-5 of the coordinate scale from a partner; eps = 1e-4 and
    eps = 0 guarded, there on the rows where the jitted JAX function is
    finite): 1e-9 of max|a|, 1e-8 of max|j|, 1e-10 of max|phi|.
    Both sides are the same ~48-bit arithmetic in another order (XLA fuses,
    eager PyTorch does not), so they agree far inside the tier's own
    distance from f64; and against the f64 oracle at the JAX tests' own
    tolerances (tests/unit/test_df32.py: 1e-8 of the largest row for accel
    and jerk, 1e-10 for phi);
  * against the Pallas kernels ``_accel_kernel_df`` and
    ``_accel_jerk_kernel_df`` in interpret mode, at that mode's limit (5e-7,
    5e-6: XLA:CPU's simplifier degrades the kernel body's transforms there,
    tests/unit/test_pallas_tiers.py; the jnp functions are the sharp
    reference);
  * ``ForceModel(precision="df32")`` against the JAX ``ForceModel`` on its
    jnp backend for ``accel``, ``accel_jerk``, ``accel_potential`` and
    ``accel_jerk_on_rows``;
  * the tier as a whole: KDK steps, Hermite steps and block micro-steps at
    df32 from one numpy state, port against JAX: the same step counts and
    times, positions to 1e-10 of the cluster size (the forces agree to
    ~1e-12, and a few dozen steps do not amplify that past 1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_df as jpallas_df
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.integrators.block import BlockHermite as JBlockHermite
from oc_nbody_tpu.integrators.hermite import Hermite4 as JHermite4
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK as JLeapfrogKDK
from oc_nbody_tpu.ops import df32 as jdf32
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators.block import BlockHermite
from oc_nbody_tpu_torch.integrators.hermite import Hermite4
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.ops import cuda_df
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import df32 as tdf32
from oc_nbody_tpu_torch.ops import gravity as tgravity
from test_torch_slice import numpy_kroupa, numpy_plummer

G = 1.3


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cluster(n, seed, close=50):
    """(pos, vel, mass) f64 numpy: a unit normal cluster, ``close`` of its
    particles 1e-5 from a partner (tests/unit/test_pallas_tiers.py)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos[close:2 * close] = pos[:close] + 1e-5 * rng.normal(size=(close, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _rel(got, want):
    """Largest error over the largest value."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the twins' arithmetic -------------------------------------------------

def _mixed(n=100_000, seed=3):
    rng = np.random.default_rng(seed)
    return _t(*((rng.normal(size=n) * np.exp2(rng.integers(-12, 13, n)))
                .astype(np.float32) for _ in range(2)))


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_twin_error_free_transforms_are_exact(name):
    """On 1e5 f32 pairs of magnitudes 2^-12 .. 2^12 (so the f64 check is
    itself exact), and word for word the JAX functions' results."""
    a, b = _mixed()
    hi, lo = getattr(tdf32, name)(a, b)
    exact = (a.double() + b.double() if name == "two_sum"
             else a.double() * b.double())
    assert torch.equal(hi.double() + lo.double(), exact)
    jhi, jlo = jax.jit(getattr(jdf32, name))(*_j(a.numpy(), b.numpy()))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_twin_df_rsqrt_and_df_arithmetic():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.exp(rng.uniform(-14.0, 7.0, 100_000)))
    y = tdf32.df_to_f64(tdf32.df_rsqrt(tdf32.df_from_f64(x)))
    assert float(((y - x ** -0.5) * x ** 0.5).abs().max()) < 1e-13
    # df_add / df_sub / df_mul / df_sqr / df_mul_f against f64
    u = torch.from_numpy(rng.normal(size=4096) * 1e3)
    v = torch.from_numpy(rng.normal(size=4096))
    du, dv = tdf32.df_from_f64(u), tdf32.df_from_f64(v)
    for got, want in ((tdf32.df_add(du, dv), u + v),
                      (tdf32.df_sub(du, dv), u - v),
                      (tdf32.df_mul(du, dv), u * v),
                      (tdf32.df_sqr(du), u * u),
                      (tdf32.df_mul_f(du, 3.0), 3.0 * u)):
        err = (tdf32.df_to_f64(got) - want).abs()
        assert float((err / (u.abs() + v.abs() + want.abs())).max()) < 1e-13
    hi, lo = tdf32.split(u.float())
    assert torch.equal(hi + lo, u.float())
    assert bool(((hi.view(torch.int32) & 0xFFF) == 0).all())


# ---- the three f64-in/out forms against JAX and the oracle -----------------

_FORMS = {"a": ("accel_df", False), "p": ("accel_potential_df", False),
          "j": ("accel_jerk_df", True)}


@pytest.mark.parametrize("eps", [1e-4, 0.0], ids=["eps1e-4", "eps0"])
@pytest.mark.parametrize("kind", ["a", "p", "j"])
def test_df_forms_match_jax(kind, eps):
    name, with_vel = _FORMS[kind]
    pos, vel, mass = _cluster(400, 11)
    args = (pos, vel, mass) if with_vel else (pos, mass)
    got = getattr(tdf32, name)(*_t(*args), eps, G, chunk=128)
    want = getattr(jdf32, name)(*_j(*args), eps, G, chunk=128)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tols = {"a": (1e-9,), "p": (1e-9, 1e-10), "j": (1e-9, 1e-8)}[kind]
    # at eps = 0 the jitted JAX functions fail on a few rows on XLA:CPU
    # (NaN accelerations and a potential of -1e14; their eager evaluation
    # does not: the guard's masked rsqrt(0) leaks through the fused graph),
    # so the two are compared on the rows where JAX's acceleration is finite
    finite = np.isfinite(np.asarray(want[0])).all(axis=1)
    assert finite.all() if eps > 0 else finite.mean() > 0.9
    for g, w, tol in zip(got, want, tols):
        assert g.dtype == torch.float64 and bool(g.isfinite().all())
        assert _rel(g.numpy()[finite], np.asarray(w)[finite]) < tol


def test_df_forms_against_the_f64_oracle():
    """tests/unit/test_df32.py's bounds: accel and jerk inside 1e-8 of the
    largest row (close pairs, eps = 1e-4), phi inside 1e-10 (eps = 0.05)."""
    pos, vel, mass = _cluster(400, 12)
    tp, tv, tm = _t(pos, vel, mass)

    def rows(got, want):
        return float(torch.linalg.norm(got - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    a_ref, j_ref = tgravity.accel_jerk_direct(tp, tv, tm, 1e-4)
    acc, jerk = tdf32.accel_jerk_df(tp, tv, tm, 1e-4)
    assert rows(acc, a_ref) < 1e-8 and rows(jerk, j_ref) < 1e-8
    assert rows(tdf32.accel_df(tp, tm, 1e-4), a_ref) < 1e-8
    # the tier tells itself from the f32 sum on these pairs
    assert rows(tgravity.accel(tp, tm, 1e-4), a_ref) > 1e-3
    pos, _, mass = _cluster(400, 13, close=0)
    tp, tm = _t(pos, mass)
    _, phi_ref = tgravity.accel_potential_direct(tp, tm, 0.05, G)
    _, phi = tdf32.accel_potential_df(tp, tm, 0.05, G)
    phi = phi + tgravity.self_phi(tm, 0.05, G)
    assert float((phi - phi_ref).abs().max() / phi_ref.abs().max()) < 1e-10


def test_f64_evaluation_of_the_planes_is_the_oracle_of_the_twins():
    """``dtype=torch.float64`` evaluates the same planes in f64: what the
    kernels are held to on the card. The f32 twins stay inside 1e-9 / 1e-8
    of it, and it stays inside the split's own error of the unsplit
    oracle."""
    pos, vel, mass = _cluster(300, 14)
    tp, tv, tm = _t(pos, vel, mass)
    hi, lo, gm_hi, gm_lo, e2h, e2l, vhi, vlo = tdf32._df_prepare(
        tp, tm, 1e-4, G, vel=tv)
    planes = (hi, lo, vhi, vlo)
    rest = (gm_hi, gm_lo, e2h, e2l)
    a64, j64 = cuda_df.rows_jerk_df_plain(*planes, *planes, *rest,
                                          dtype=torch.float64)
    a32, j32 = cuda_df.rows_jerk_df_plain(*planes, *planes, *rest)
    assert _rel(a32.numpy(), a64.numpy()) < 1e-9
    assert _rel(j32.numpy(), j64.numpy()) < 1e-8
    a_only = cuda_df.rows_df_plain(hi, lo, hi, lo, *rest)
    assert _rel(a_only.numpy(), a64.numpy()) < 1e-9
    a_ref, j_ref = tgravity.accel_jerk_direct(tp, tv, tm, 1e-4, G)
    assert _rel(a64.numpy(), a_ref.numpy()) < 1e-8
    assert _rel(j64.numpy(), j_ref.numpy()) < 1e-8
    with pytest.raises(TypeError, match="float32 .* or float64"):
        cuda_df.rows_df_plain(hi, lo, hi, lo, *rest, dtype=torch.float16)


# ---- against the Pallas kernels, interpret mode ----------------------------

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    jitted = (jpallas_df.accel_df_pallas, jpallas_df.accel_jerk_df_pallas)
    for fn in jitted:
        fn.clear_cache()
    yield
    for fn in jitted:
        fn.clear_cache()


@pytest.mark.parametrize("eps", [1e-4, 0.0], ids=["eps1e-4", "eps0"])
def test_wrappers_match_the_pallas_kernels_in_interpret_mode(interpret, eps):
    """``cuda_df.accel_df`` / ``accel_jerk_df`` (on the CPU: the twins)
    against Pallas #21 and #22."""
    pos, vel, mass = _cluster(320, 15)
    guarded = eps == 0.0
    before = dict(cg.PLAIN_CALLS), dict(cg.LAUNCHES)
    acc = cuda_df.accel_df(*_t(pos, mass), eps, G, guarded=guarded)
    acc2, jerk = cuda_df.accel_jerk_df(*_t(pos, vel, mass), eps, G,
                                       guarded=guarded)
    assert cg.PLAIN_CALLS["rows_df"] == before[0]["rows_df"] + 1
    assert cg.PLAIN_CALLS["rows_jerk_df"] == before[0]["rows_jerk_df"] + 1
    assert cg.LAUNCHES == before[1]           # no kernel on CPU tensors
    want = jpallas_df.accel_df_pallas(*_j(pos, mass), eps, G,
                                      guarded=guarded)
    want2, jwant = jpallas_df.accel_jerk_df_pallas(*_j(pos, vel, mass), eps,
                                                   G, guarded=guarded)
    assert _rel(acc.numpy(), want) < 5e-7
    assert _rel(acc2.numpy(), want2) < 5e-7
    assert _rel(jerk.numpy(), jwant) < 5e-6


def test_wrappers_refuse_what_the_kernels_do_not_take():
    big = torch.zeros((cg.STREAM_N + 1, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="STREAM_N"):
        cuda_df.accel_df(big, big[:, 0], 0.1)
    with pytest.raises(NotImplementedError, match="STREAM_N"):
        cuda_df.accel_jerk_df(big, big, big[:, 0], 0.1)
    pos, vel, mass = _t(*_cluster(16, 1, close=0))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        cuda_df.accel_df(pos.to("meta"), mass, 0.1)


# ---- the force model's routes ----------------------------------------------

def _models(eps, external=False):
    text = jext = None
    if external:
        from oc_nbody_tpu.models import potentials as jpot
        from oc_nbody_tpu_torch.models import potentials as tpot
        jext = jpot.milky_way(G, 1e-4, 1.0 / 3.0)
        text = tpot.milky_way(G, 1e-4, 1.0 / 3.0)
    return (t_make_force_model(eps, G, text, precision="df32"),
            j_make_force_model(eps=eps, G=G, external=jext, backend="jnp",
                               precision="df32", chunk=128))


@pytest.mark.parametrize("route", ["accel", "accel_jerk", "accel_potential",
                                   "accel_jerk_on_rows"])
def test_force_model_df32_routes_match_jax(route):
    """Masses are f32-representable f64 on the JAX side (its state's f32
    masses would cancel the potential's self term in f32)."""
    pos, vel, mass = _cluster(300, 16)
    mass = mass.astype(np.float32)
    tp, tv = _t(pos, vel)
    tm = torch.from_numpy(mass)
    jp, jv, jm = _j(pos, vel, mass.astype(np.float64))
    tforce, jforce = _models(1e-3, external=True)
    assert tforce.precision == "df32" and tforce.pair_dtype == torch.float64
    plain = dict(cg.PLAIN_CALLS)
    if route == "accel":
        got, want = (tforce.accel(tp, tm),), (jforce.accel(jp, jm),)
        tols, ran = (1e-9,), {"rows_df"}
    elif route == "accel_jerk":
        got, want = tforce.accel_jerk(tp, tv, tm), jforce.accel_jerk(jp, jv,
                                                                     jm)
        tols, ran = (1e-9, 1e-8), {"rows_jerk_df"}
    elif route == "accel_potential":
        got = tforce.accel_potential(tp, tm)
        want = jforce.accel_potential(jp, jm)
        tols, ran = (1e-9, 1e-10, 1e-12), set()    # the f64 sum: no twin
    else:
        rows = np.arange(0, 300, 7)
        got = tforce.accel_jerk_on_rows(tp[rows], tv[rows], tp, tv, tm)
        want = jforce.accel_jerk_on_rows(jp[rows], jv[rows], jp, jv, jm)
        tols, ran = (1e-12, 1e-12), set()          # f64 on both sides
    assert {k for k in plain if cg.PLAIN_CALLS[k] != plain[k]} == ran
    for g, w, tol in zip(got, want, tols):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), w) < tol


def test_centred_sources_and_pair_rows_at_df32():
    """The block stepper's view of the force model: uncentred f64 sources,
    f64 pair sums of the gathered rows."""
    pos, vel, mass = _cluster(64, 17, close=8)
    tp, tv = _t(pos + [8000.0, 0.0, 0.0], vel)
    tm = torch.from_numpy(mass.astype(np.float32))
    force = t_make_force_model(1e-3, G, precision="df32")
    src, svel, m64, centre, vcentre = force.centred_sources(tp, tv, tm)
    assert src is tp and svel is tv and m64.dtype == torch.float64
    assert centre is None and vcentre is None
    rows = torch.tensor([3, 9, 11])
    acc, jerk = force.pair_accel_jerk_rows(src[rows], svel[rows], src, svel,
                                           m64)
    a_ref, j_ref = tgravity.accel_jerk_direct(tp, tv, m64, 1e-3, G)
    assert acc.dtype == torch.float64
    assert _rel(acc.numpy(), a_ref[rows].numpy()) < 1e-9   # 8 kpc out
    assert _rel(jerk.numpy(), j_ref[rows].numpy()) < 1e-9
    with pytest.raises(ValueError, match="unknown precision"):
        t_make_force_model(0.01, precision="quad")


# ---- the tier as a whole ---------------------------------------------------

N_SLICE = 256


def _state(seed, kroupa=False):
    pos, vel, mass, ids = numpy_plummer(N_SLICE, seed)
    if kroupa:
        mass = numpy_kroupa(N_SLICE, seed + 1)
    size = float(np.abs(pos).max())
    return (state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"),
            j_make_state(pos, vel, mass, ids), size)


def _forces(eps):
    return (t_make_force_model(eps, 1.0, precision="df32"),
            j_make_force_model(eps=eps, G=1.0, backend="jnp",
                               precision="df32", chunk=128))


def test_kdk_steps_at_df32_match_jax():
    tstate, jstate, size = _state(21)
    tforce, jforce = _forces(1.0 / 64)
    dt = 1.0 / 512
    tc = LeapfrogKDK(force=tforce, dt=dt)
    tcarry = tc.advance(tc.init(tstate), 16)
    jc = JLeapfrogKDK(force=jforce, dt=dt)
    jcarry = jax.jit(jc.advance, static_argnums=1)(jc.init(jstate), 16)
    assert tcarry.n_steps == int(jcarry.n_steps) == 16
    assert tcarry.state.time == float(jcarry.state.time)
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(jcarry.state.pos), rtol=0,
                               atol=1e-10 * size)
    np.testing.assert_allclose(tcarry.state.vel.numpy(),
                               np.asarray(jcarry.state.vel), rtol=0,
                               atol=1e-10)


def test_hermite_steps_at_df32_match_jax():
    """On the CPU both packages run the two-float jerk twin; the shared dt
    follows from forces that agree to ~1e-12, so the step sequence is the
    same."""
    tstate, jstate, size = _state(22, kroupa=True)
    tforce, jforce = _forces(1.0 / 256)
    kw = dict(eta=0.02, eta_init=0.01, dt_max=1.0 / 16)
    th = Hermite4(force=tforce, **kw)
    tcarry = th.advance_to(th.init(tstate), 1.0 / 64)
    jh = JHermite4(force=jforce, **kw)
    jcarry = jax.jit(jh.advance_to)(jh.init(jstate), 1.0 / 64)
    assert tcarry.n_steps == int(jcarry.n_steps) > 4
    assert tcarry.state.time == float(jcarry.state.time)
    np.testing.assert_allclose(tcarry.dt, float(jcarry.dt), rtol=1e-8)
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(jcarry.state.pos), rtol=0,
                               atol=1e-10 * size)


@pytest.mark.parametrize("pec2", [False, True], ids=["pec", "pec2"])
def test_block_micro_steps_at_df32_match_jax(pec2):
    """K11's twin at init, then f64 row sums on both sides: the same
    micro-step count, active-row total and rungs, positions to 1e-10 of the
    cluster size."""
    tstate, jstate, size = _state(23, kroupa=True)
    tforce, jforce = _forces(1.0 / 256)
    kw = dict(eta=0.02, eta_init=0.01, dt_max=1.0 / 64, n_levels=8,
              pec2=pec2)
    tb = BlockHermite(force=tforce, **kw)
    plain = dict(cg.PLAIN_CALLS)
    tcarry = tb.advance_to(tb.init(tstate), 1.0 / 64)
    ran = {k: cg.PLAIN_CALLS[k] - plain[k] for k in plain
           if cg.PLAIN_CALLS[k] != plain[k]}
    assert ran == {"rows_jerk_df": 1}           # init only
    jb = JBlockHermite(force=jforce, **kw)
    jcarry = jax.jit(jb.advance_to)(jb.init(jstate), 1.0 / 64)
    assert tcarry.n_steps == int(jcarry.n_steps) > 4
    assert tcarry.n_active_sum == int(jcarry.n_active_sum)
    assert tcarry.state.time == float(jcarry.state.time) == 1.0 / 64
    np.testing.assert_array_equal(tcarry.dt_i.numpy(),
                                  np.asarray(jcarry.dt_i))
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(jcarry.state.pos), rtol=0,
                               atol=1e-10 * size)
    np.testing.assert_allclose(tcarry.acc.numpy(), np.asarray(jcarry.acc),
                               rtol=0, atol=1e-9 * float(
                                   np.abs(np.asarray(jcarry.acc)).max()))
