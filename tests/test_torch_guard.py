"""The zero guard at eps = 0: the port's plain twins against the JAX package
on a pair closer than ~1e-19, at the f32, extended and df32 tiers.

At eps = 0 the JAX package guards the inverse distance with ``_inv_r``
(oc_nbody_tpu/ops/pallas_pair.py:71-77; the df32 seed, pallas_df.py:91-94):
u > 0 ? rsqrt(max(u, 2^-126)) : 0, in f32 arithmetic that flushes a
subnormal u to 0 (XLA on the CPU, as the TPU). A pair whose u = |d|^2 is
below 2^-126 therefore adds nothing to either star, in every JAX route: the
jnp forms and the Pallas kernels in interpret mode alike. PyTorch keeps
subnormals, so the port spells the flush out (``ops/gravity.py:_inv_r``,
``csrc/pair.cuh:inv_r``): u below 2^-126 gives 0. Before that, the port's
twins and most of its kernels clamped such a u to 2^-126 and overflowed the
pair to inf, while K2 and K12 gave 0 (ROADMAP C6).

The set: 62 stars at dyadic coordinates in +-pairs, one at the origin and
one 2^-66 (~1.4e-20) from it on each axis, so that centring is exact in f64
and f32 and the pair keeps u = 3 * 2^-132 on both sides. Each twin must
give the same non-finite entries as the JAX route (none: the pair adds
nothing) and equal finite entries elsewhere: 1e-6·max|a| (1e-6·max|j|) and
phi rtol 1e-6, f32 sums of the same terms in different orders over 64
stars. The Pallas sym tiles are lowered to 64 as
tests/unit/test_pallas_interpret.py sets them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_df as jpallas_df
import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu.ops import df32 as jdf32
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.ops.pallas_pair import _inv_r as j_inv_r
from oc_nbody_tpu_torch.ops import cuda_df
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import gravity as tgrav

G = 1.3
SEP = 2.0 ** -66
_PALLAS = (pg.accel_sym, pg.accel_potential_sym, pg.accel_jerk_sym,
           pg.accel_sym_x, pg.accel_potential_x, pg.accel_jerk_sym_x,
           jpallas_df.accel_df_pallas, jpallas_df.accel_jerk_df_pallas)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    for name in ("T_SYMA", "T_SYMP", "T_SYM", "T_SYMX", "T_SYMXP",
                 "T_SYMXJ"):
        monkeypatch.setattr(pg, name, 64)
    for fn in _PALLAS:
        fn.clear_cache()
    yield
    for fn in _PALLAS:
        fn.clear_cache()


def _close_pair_set():
    rng = np.random.default_rng(5)
    half = rng.integers(-4096, 4096, size=(31, 3)) / 1024.0
    pos = np.concatenate([half, -half, np.zeros((1, 3)),
                          np.full((1, 3), SEP)])
    vel = rng.normal(size=(64, 3)) * 0.5
    mass = rng.uniform(0.5, 1.5, 64) / 64
    return pos, vel, mass


# form -> (the port's twins, the JAX jnp form, the JAX Pallas form); each
# takes (pos, vel, mass) and returns a tuple of outputs
_FORMS = {
    "accel": ((lambda p, v, m: (cg.accel(p, m, 0.0, G),),
               lambda p, v, m: (cg.accel_sym(p, m, 0.0, G),)),
              lambda p, v, m: (jgrav.accel(p, m, 0.0, G),),
              lambda p, v, m: (pg.accel_sym(p, m, 0.0, G),)),
    "accel_potential": ((lambda p, v, m: cg.accel_potential(p, m, 0.0, G),
                         lambda p, v, m: cg.accel_potential_sym(p, m, 0.0,
                                                                G)),
                        lambda p, v, m: jgrav.accel_potential(p, m, 0.0, G),
                        lambda p, v, m: pg.accel_potential_sym(p, m, 0.0, G)),
    "accel_jerk": ((lambda p, v, m: cg.accel_jerk(p, v, m, 0.0, G),
                    lambda p, v, m: cg.accel_jerk_sym(p, v, m, 0.0, G)),
                   lambda p, v, m: jgrav.accel_jerk(p, v, m, 0.0, G),
                   lambda p, v, m: pg.accel_jerk_sym(p, v, m, 0.0, G)),
    "accel_x": ((lambda p, v, m: (cg.accel_x(p, m, 0.0, G),),
                 lambda p, v, m: (cg.accel_sym_x(p, m, 0.0, G),)),
                lambda p, v, m: (jdf32.accel_extended(p, m, 0.0, G),),
                lambda p, v, m: (pg.accel_sym_x(p, m, 0.0, G),)),
    "accel_potential_x": (
        (lambda p, v, m: cg.accel_potential_x(p, m, 0.0, G),
         lambda p, v, m: cg.accel_potential_sym_x(p, m, 0.0, G)),
        lambda p, v, m: jdf32.accel_potential_extended(p, m, 0.0, G),
        lambda p, v, m: pg.accel_potential_x(p, m, 0.0, G)),
    "accel_jerk_x": ((lambda p, v, m: cg.accel_jerk_x(p, v, m, 0.0, G),
                      lambda p, v, m: cg.accel_jerk_sym_x(p, v, m, 0.0, G)),
                     lambda p, v, m: jdf32.accel_jerk_extended(p, v, m, 0.0,
                                                               G),
                     lambda p, v, m: pg.accel_jerk_sym_x(p, v, m, 0.0, G)),
    "accel_df": ((lambda p, v, m: (cuda_df.accel_df(p, m, 0.0, G),),),
                 lambda p, v, m: (jdf32.accel_df(p, m, 0.0, G),),
                 lambda p, v, m: (jpallas_df.accel_df_pallas(p, m, 0.0, G),)),
    "accel_jerk_df": ((lambda p, v, m: cuda_df.accel_jerk_df(p, v, m, 0.0,
                                                             G),),
                      lambda p, v, m: jdf32.accel_jerk_df(p, v, m, 0.0, G),
                      lambda p, v, m: jpallas_df.accel_jerk_df_pallas(
                          p, v, m, 0.0, G)),
}


def _same_answer(got, want, what):
    """The same non-finite entries (NaN where NaN, +-inf where +-inf) and
    the finite ones equal: vectors to 1e-6 of their max, phi rtol 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf, what)
    np.testing.assert_array_equal(got[inf], want[inf], what)
    fin = np.isfinite(want)
    atol = 0.0 if want.ndim == 1 else 1e-6 * np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("route", ["jnp", "pallas"])
@pytest.mark.parametrize("form", sorted(_FORMS))
def test_twins_match_jax_on_a_pair_closer_than_1e_19(form, route):
    """Every twin of ``form`` gives what the JAX route gives on the set
    with the pair 2^-66 apart at eps = 0: nothing from the pair, so every
    entry finite; the pair's stars feel only the other 62."""
    pos, vel, mass = _close_pair_set()
    twins, jnp_form, pallas_form = _FORMS[form]
    jax_form = jnp_form if route == "jnp" else pallas_form
    want = jax_form(*(jnp.asarray(a) for a in (pos, vel, mass)))
    assert all(bool(np.isfinite(np.asarray(w)).all()) for w in want)
    for twin in twins:
        got = twin(*(torch.from_numpy(a) for a in (pos, vel, mass)))
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            _same_answer(g.numpy(), w, f"{form} output {k} vs {route}")


def test_inv_r_flushes_below_the_least_normal_float_as_jax_does():
    """The guard itself: 0 for u = 0 and for a subnormal u, rsqrt(u) from
    2^-126 up, in the twin and in JAX's ``_inv_r`` on f32."""
    tiny = np.finfo(np.float32).tiny
    u = np.array([0.0, 3 * 2.0 ** -132, tiny / 2, tiny, 1.0, 4.0],
                 np.float32)
    want = np.asarray(jax.jit(lambda x: j_inv_r(x, True))(jnp.asarray(u)))
    got = tgrav._inv_r(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], 0.0)
    assert got[3] == np.float32(2.0 ** 63)
