"""The port's Milky Way (Hernquist + Miyamoto–Nagai + NFW) against the JAX
package in f64 at random points: phi, accel, v_circ, the autodiff tidal
tensor and the tidal coefficient, to rtol 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oc_nbody_tpu.models import potentials as jpot
from oc_nbody_tpu_torch.models import potentials as tpot

# the north star's unit scaling (units.mass_msun 5e4, length_pc 10): the
# cluster orbits at R = 800 code lengths
G = 1.0
MASS_SCALE, LENGTH_SCALE = 1.0 / 5.0e4, 1.0 / 10.0
RTOL = 1e-10


@pytest.fixture(scope="module")
def pots():
    return (jpot.milky_way(G, MASS_SCALE, LENGTH_SCALE),
            tpot.milky_way(G, MASS_SCALE, LENGTH_SCALE))


def _points(n=64, seed=3):
    rng = np.random.default_rng(seed)
    R = rng.uniform(5.0, 3000.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    z = rng.normal(scale=60.0, size=n)
    return np.stack([R * np.cos(ang), R * np.sin(ang), z], axis=1)


def test_phi_and_accel(pots):
    jmw, tmw = pots
    xyz = _points()
    t = torch.from_numpy(xyz)
    np.testing.assert_allclose(tmw.phi(t).numpy(),
                               np.asarray(jmw.phi(jnp.asarray(xyz))),
                               rtol=RTOL)
    np.testing.assert_allclose(tmw.accel(t).numpy(),
                               np.asarray(jmw.accel(jnp.asarray(xyz))),
                               rtol=RTOL, atol=0)
    for tc, jc in zip(tmw.components, jmw.components):
        np.testing.assert_allclose(tc.accel(t).numpy(),
                                   np.asarray(jc.accel(jnp.asarray(xyz))),
                                   rtol=RTOL)


def test_vcirc_and_omega2(pots):
    jmw, tmw = pots
    for R in (20.0, 300.0, 800.0, 2000.0):
        np.testing.assert_allclose(float(tmw.vcirc(R)),
                                   float(jmw.vcirc(R)), rtol=RTOL)
        np.testing.assert_allclose(float(tmw.omega2(R)),
                                   float(jmw.omega2(R)), rtol=RTOL)
        np.testing.assert_allclose(float(tmw.dphi_dR(R)),
                                   float(jmw.dphi_dR(R)), rtol=RTOL)
    Rs = np.array([100.0, 800.0])
    np.testing.assert_allclose(tmw.vcirc(torch.from_numpy(Rs)).numpy(),
                               np.asarray(jmw.vcirc(jnp.asarray(Rs))),
                               rtol=RTOL)


def test_tidal_tensor_and_coefficient(pots):
    jmw, tmw = pots
    rng = np.random.default_rng(5)
    for xyz in _points(n=6, seed=7):
        T_t = tmw.tidal_tensor(torch.from_numpy(xyz)).numpy()
        T_j = np.asarray(jmw.tidal_tensor(jnp.asarray(xyz)))
        np.testing.assert_allclose(T_t, T_j, rtol=RTOL,
                                   atol=RTOL * np.abs(T_j).max())
        omega2 = float(rng.uniform(0.0, 1e-4))
        np.testing.assert_allclose(
            float(tmw.tidal_coefficient_at(torch.from_numpy(xyz), omega2)),
            float(jmw.tidal_coefficient_at(jnp.asarray(xyz), omega2)),
            rtol=RTOL)


def test_closed_form_external_jerk_matches_jax(pots):
    """Each component's closed-form (a, (v·∇)a) against the JAX package's
    jax.jvp and against the port's own torch.func.jvp (the base class), to
    rtol 1e-10 of the largest component; zero at the centre, not NaN."""
    jmw, tmw = pots
    xyz = np.concatenate([_points(), [[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]]])
    vel = np.random.default_rng(9).normal(scale=20.0, size=xyz.shape)
    t, v = torch.from_numpy(xyz), torch.from_numpy(vel)
    for tc, jc in list(zip(tmw.components, jmw.components)) + [(tmw, jmw)]:
        got = tc.accel_jerk_ext(t, v)
        for ref in (jc.accel_jerk_ext(jnp.asarray(xyz), jnp.asarray(vel)),
                    tpot.Potential.accel_jerk_ext(tc, t, v)):
            for g, r in zip(got, ref):
                r = np.asarray(r)
                finite = np.isfinite(r).all(axis=1)
                np.testing.assert_allclose(
                    g.numpy()[finite], r[finite], rtol=0,
                    atol=RTOL * np.abs(r[finite]).max())
        assert all(bool(torch.isfinite(x).all()) for x in got)
