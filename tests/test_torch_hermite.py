"""The port's shared-dt Hermite-4 stepper against the JAX package's.

Two layers, both from one numpy Plummer IC with Kroupa masses at N = 512:

* The step math. Both steppers get the same f64 direct-sum forces (each
  package's own ``accel_jerk_direct``, plus the Milky Way field's exact
  external jerk on the orbit case: the port's ``torch.func.jvp`` against
  ``jax.jvp``), so what is compared is prediction, correction, the
  interpolated derivatives, the Aarseth criterion, the growth limit, the
  landing clip, quantization, PEC² and the symmetrized trial pass. After
  64 steps each dt in the sequence agrees to 1e-6 relative (measured
  ~2e-11; 1e-7 on the orbit), positions to 1e-9 of the cluster size
  (measured ~1e-15; 2e-11 on the orbit), and ``advance_to(t)`` takes
  exactly as many steps.
* The force path. With each package's own f32 force model (the JAX jnp
  ops, the port's plain twins) the two sum their pairs in different
  orders, ~1e-7·|a| apart. The Aarseth criterion forms (a0 − a1)/dt² from
  those forces, which amplifies that by ~|a|/(|j| dt): the dt sequences
  differ by up to 1% (measured 0.97%), except with quantization, where
  they are equal. Through ``advance_to(t)`` both land on t in as many
  steps, with positions within 1e-8 of the cluster size: the worst star
  is one of a close pair, whose |a| carries the 1e-7 relative rounding
  into its position (measured over seeds 7-13 at t = 0.03: at most
  4.6e-9, and ≤ 1e-9 for every other star).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.integrators import hermite as jhermite
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators import hermite as thermite
from oc_nbody_tpu_torch.interop import (hermite_carry_from_numpy,
                                        hermite_carry_to_numpy,
                                        state_from_numpy)
from oc_nbody_tpu_torch.ops import gravity as tgrav

from test_torch_slice import C2, numpy_kroupa, numpy_plummer

N = 512
EPS = 1.0 / 256
STEPPER = dict(eta=0.02, eta_init=0.01, dt_max=1.0 / 16)   # c3's


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass(frozen=True)
class JaxDirectForce:
    """The JAX package's f64 oracle as a Hermite force model."""
    eps: float
    G: float = 1.0
    external: object = None

    def at_time(self, t):
        return self

    def accel_jerk(self, pos, vel, mass):
        acc, jerk = jgrav.accel_jerk_direct(pos, vel, mass, self.eps, self.G)
        if self.external is not None:
            a_ext, j_ext = self.external.accel_jerk_ext(pos, vel)
            acc, jerk = acc + a_ext, jerk + j_ext
        return acc, jerk


@dataclasses.dataclass(frozen=True)
class PortDirectForce(JaxDirectForce):
    """The port's f64 oracle as a Hermite force model."""

    def accel_jerk(self, pos, vel, mass):
        acc, jerk = tgrav.accel_jerk_direct(pos, vel, mass, self.eps, self.G)
        if self.external is not None:
            a_ext, j_ext = self.external.accel_jerk_ext(pos, vel)
            acc, jerk = acc + a_ext, jerk + j_ext
        return acc, jerk


def kroupa_plummer(n, seed):
    """numpy Plummer IC with Kroupa masses."""
    pos, vel, _, ids = numpy_plummer(n, seed)
    return pos, vel, numpy_kroupa(n, seed + 1), ids


def _milky_way_orbit(pos, vel, mass, ids):
    """c2's Milky Way and circular 8 kpc orbit, for both packages."""
    cfg_j, cfg_t = jconfig.load_config(C2), tconfig.load_config(C2)
    us = jscene.build_units(cfg_j)
    jext = jscene.build_external_potential(cfg_j, us)
    text = tscene.build_external_potential(cfg_t, tscene.build_units(cfg_t))
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), jext,
                                  cfg_j, us)
    return np.asarray(state.pos), np.asarray(state.vel), jext, text


def _run_both(js, ts, ic, n_steps):
    """(JAX dts, port dts, JAX carry, port carry) after n_steps steps."""
    jcarry = js.init(j_make_state(*ic))
    tcarry = ts.init(state_from_numpy(*ic, 0.0, "cpu"))
    jstep = jax.jit(js.step)
    jdts, tdts = [float(jcarry.dt)], [tcarry.dt]
    for _ in range(n_steps):
        jcarry, tcarry = jstep(jcarry), ts.step(tcarry)
        jdts.append(float(jcarry.dt))
        tdts.append(tcarry.dt)
    return np.array(jdts), np.array(tdts), jcarry, tcarry


VARIANTS = {"plain": {}, "quantize": {"quantize": True},
            "pec2": {"pec2": True}, "symmetrized": {"symmetrized": True},
            "orbit": {}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_math_matches_jax(variant):
    pos, vel, mass, ids = kroupa_plummer(N, seed=5)
    size = float(np.abs(pos).max())
    jext = text = None
    if variant == "orbit":
        pos, vel, jext, text = _milky_way_orbit(pos, vel, mass, ids)
    ic = (pos, vel, mass, ids)
    kw = dict(STEPPER, **VARIANTS[variant])
    js = jhermite.Hermite4(force=JaxDirectForce(EPS, external=jext), **kw)
    ts = thermite.Hermite4(force=PortDirectForce(EPS, external=text), **kw)

    jdts, tdts, jcarry, tcarry = _run_both(js, ts, ic, 64)
    np.testing.assert_allclose(tdts, jdts, rtol=1e-6, atol=0)
    assert tcarry.n_steps == int(jcarry.n_steps) == 64
    np.testing.assert_allclose(tcarry.state.time, float(jcarry.state.time),
                               rtol=1e-9)
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(jcarry.state.pos), rtol=0,
                               atol=1e-9 * size)

    t_end = 0.75 * tcarry.state.time
    jc = jax.jit(js.advance_to)(js.init(j_make_state(*ic)), t_end)
    tc = ts.advance_to(ts.init(state_from_numpy(*ic, 0.0, "cpu")), t_end)
    assert tc.n_steps == int(jc.n_steps)
    assert tc.state.time == float(jc.state.time)
    assert ts.reached(tc, t_end)
    np.testing.assert_allclose(tc.state.pos.numpy(), np.asarray(jc.state.pos),
                               rtol=0, atol=1e-9 * size)
    np.testing.assert_allclose(tc.dt, float(jc.dt), rtol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "quantize", "orbit"])
def test_force_model_path_matches_jax(variant):
    pos, vel, mass, ids = kroupa_plummer(N, seed=7)
    size = float(np.abs(pos).max())
    jext = text = None
    if variant == "orbit":
        pos, vel, jext, text = _milky_way_orbit(pos, vel, mass, ids)
    ic = (pos, vel, mass, ids)
    kw = dict(STEPPER, **VARIANTS[variant])
    js = jhermite.Hermite4(force=j_make_force_model(
        eps=EPS, external=jext, backend="jnp"), **kw)
    ts = thermite.Hermite4(force=t_make_force_model(EPS, 1.0, text), **kw)
    jdts, tdts, _, _ = _run_both(js, ts, ic, 32)
    if variant == "quantize":
        np.testing.assert_array_equal(tdts, jdts)
    else:
        np.testing.assert_allclose(tdts, jdts, rtol=2e-2, atol=0)
    t_end = 0.03
    jc = jax.jit(js.advance_to)(js.init(j_make_state(*ic)), t_end)
    tc = ts.advance_to(ts.init(state_from_numpy(*ic, 0.0, "cpu")), t_end)
    assert tc.n_steps == int(jc.n_steps)
    assert tc.state.time == float(jc.state.time)
    np.testing.assert_allclose(tc.state.pos.numpy(), np.asarray(jc.state.pos),
                               rtol=0, atol=1e-8 * size)


def test_port_continues_a_jax_carry():
    """A JAX Hermite carry, carried across as numpy, is continued by the
    port as JAX continues it; the carry survives the round trip."""
    ic = kroupa_plummer(N, seed=9)
    js = jhermite.Hermite4(force=JaxDirectForce(EPS), **STEPPER)
    ts = thermite.Hermite4(force=PortDirectForce(EPS), **STEPPER)
    jstep = jax.jit(js.step)
    jcarry = js.init(j_make_state(*ic))
    for _ in range(16):
        jcarry = jstep(jcarry)
    s = jcarry.state
    fields = (s.pos, s.vel, s.mass, s.ids, s.time, jcarry.acc, jcarry.jerk,
              jcarry.dt, jcarry.n_steps)
    tcarry = hermite_carry_from_numpy(*(np.asarray(f) for f in fields),
                                      device="cpu")
    for got, want in zip(hermite_carry_to_numpy(tcarry), fields):
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype
    for _ in range(16):
        jcarry, tcarry = jstep(jcarry), ts.step(tcarry)
        np.testing.assert_allclose(tcarry.dt, float(jcarry.dt), rtol=1e-6)
    assert tcarry.n_steps == int(jcarry.n_steps) == 32
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(jcarry.state.pos), rtol=0,
                               atol=1e-9 * float(np.abs(ic[0]).max()))


def test_shape_dt_matches_jax_bitwise():
    """The host-side clamp and quantization equal the JAX package's device
    version on every value, exact powers of two and their one-ulp
    neighbours included (rungs k < 24)."""
    dt_max = 1.0 / 16
    values = [dt_max / 2.0 ** k * f for k in range(24)
              for f in (1.0, 1.0 - 2e-16, 1.0 + 2e-16, 0.7, 1.3)]
    values += list(np.random.default_rng(1).uniform(1e-7, 0.2, 200))
    values += [0.0, 1e-300, math.inf, 5.0]
    for dt_min in (0.0, 1e-5):
        for quantize in (False, True):
            want = np.asarray(jax.jit(
                lambda d: jhermite._shape_dt_fn(d, dt_min, dt_max, quantize))(
                    jnp.asarray(values, jnp.float64)))
            got = [thermite._shape_dt_fn(v, dt_min, dt_max, quantize)
                   for v in values]
            np.testing.assert_array_equal(got, want)


def test_lands_counts_and_refuses():
    ic = kroupa_plummer(64, seed=11)
    force = t_make_force_model(1.0 / 32, 1.0)
    stepper = thermite.Hermite4(force=force, eta=0.02, dt_max=1.0 / 8,
                                quantize=True)
    carry = stepper.init(state_from_numpy(*ic, 0.0, "cpu"))
    for _ in range(5):
        carry = stepper.step(carry)
        ratio = (1.0 / 8) / carry.dt
        assert ratio == 2.0 ** round(math.log2(ratio))
    t_end = 0.3125
    carry = stepper.advance_to(carry, t_end)
    assert carry.state.time == pytest.approx(t_end, rel=1e-14)
    assert stepper.reached(carry, t_end)
    assert not stepper.reached(carry, t_end + 1e-3)
    aux = stepper.checkpoint_aux(carry)
    assert set(aux) == {"acc", "jerk", "dt", "n_steps"}
    assert aux["n_steps"] == carry.n_steps and aux["jerk"] is carry.jerk
    with pytest.raises(ValueError, match="finite dt_max"):
        thermite.Hermite4(force=force, quantize=True)


@pytest.mark.parametrize("scene", ["isolated", "orbit"])
def test_extended_force_path_matches_jax(scene, monkeypatch):
    """The Hermite force evaluation at the extended tier: the JAX package's
    ForceModel(backend="pallas", precision="extended") through Pallas
    kernel #12 (interpret mode; N < SYM_MIN), the port's through K9's twin.
    accel and jerk agree to the f32 pair tolerances (5e-6 of max|a|, 1e-5
    of max|j|, pairwise parts), and advance_to(1/64) lands on that time in
    as many steps with positions within 1e-8 of the cluster size (the f32
    force path's bound above: the dt sequences differ by the f32 rounding
    the Aarseth criterion amplifies)."""
    import oc_nbody_tpu.ops.pallas_gravity as pg
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    pg.accel_jerk_rows_x.clear_cache()
    n = 256
    pos, vel, mass, ids = kroupa_plummer(n, seed=21)
    size = float(np.abs(pos).max())
    jext = text = None
    if scene == "orbit":
        pos, vel, jext, text = _milky_way_orbit(pos, vel, mass, ids)
    jf = j_make_force_model(eps=EPS, external=jext, backend="pallas",
                            precision="extended")
    tf = t_make_force_model(EPS, 1.0, text, precision="extended")
    tstate = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    try:
        want = jf.accel_jerk(jnp.asarray(pos), jnp.asarray(vel),
                             jnp.asarray(mass))
        js = jhermite.Hermite4(force=jf, **STEPPER)
        jc = jax.jit(js.advance_to)(
            js.init(j_make_state(pos, vel, mass, ids)), 1.0 / 64)
    finally:
        pg.accel_jerk_rows_x.clear_cache()
    got = tf.accel_jerk(tstate.pos, tstate.vel, tstate.mass)
    pair = jgrav.accel_jerk_direct(jnp.asarray(pos), jnp.asarray(vel),
                                   jnp.asarray(mass), EPS)
    for g, w, pr, tol in zip(got, want, pair, (5e-6, 1e-5)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol * np.abs(np.asarray(pr)).max())
    ts = thermite.Hermite4(force=tf, **STEPPER)
    tc = ts.advance_to(ts.init(tstate), 1.0 / 64)
    assert tc.n_steps == int(jc.n_steps) > 4
    assert tc.state.time == float(jc.state.time) == 1.0 / 64
    np.testing.assert_allclose(tc.state.pos.numpy(), np.asarray(jc.state.pos),
                               rtol=0, atol=1e-8 * size)
