"""The port's initial conditions against the JAX package's: the IMF inverse
CDF on JAX's own uniforms, the King IC from one seed, Plummer with given
masses, and the c2 / c3 scenes' ICs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.models import imf as jimf
from oc_nbody_tpu.models import king as jking
from oc_nbody_tpu.models.plummer import plummer as j_plummer
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.models import imf as timf
from oc_nbody_tpu_torch.models import king as tking
from oc_nbody_tpu_torch.models.plummer import plummer as t_plummer

from test_torch_slice import C2, C3


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_uniforms(key, n):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, (n,), jnp.float64)))


@pytest.mark.parametrize("m_min,m_max", [(0.08, 100.0), (0.01, 100.0),
                                         (0.1, 0.3), (0.6, 20.0)])
def test_kroupa_inverse_cdf_on_jax_uniforms(m_min, m_max):
    """Bitwise-equal uniforms in, the JAX package's masses out (to f64
    rounding of pow/exp), for one to three power-law segments."""
    key = jax.random.PRNGKey(17)
    n = 4096
    want = np.asarray(jimf.kroupa_imf(n, key, m_min=m_min, m_max=m_max))
    got = timf.inverse_cdf(_jax_uniforms(key, n),
                           *timf.kroupa_segments(m_min, m_max)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    assert got.min() >= m_min and got.max() <= m_max * (1 + 1e-12)


def test_salpeter_and_the_logarithmic_segment_match_jax():
    """Salpeter's single segment, and an alpha = 1 segment (p == 0, the
    exact logarithmic branch)."""
    key = jax.random.PRNGKey(23)
    n = 2048
    u = _jax_uniforms(key, n)
    want = np.asarray(jimf.salpeter_imf(n, key))
    got = timf.inverse_cdf(u, (0.4, 10.0), (2.35,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    edges, alphas = (0.1, 1.0, 10.0), (1.0, 2.3)
    want = np.asarray(jimf._broken_power_law(key, n, edges, alphas,
                                             jnp.float64))
    got = timf.inverse_cdf(u, edges, alphas).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_samplers_draw_from_a_torch_generator():
    """Same seed, same masses; the share of stars above 0.5 Msun is the
    Kroupa CDF's: N(>0.5)/N = 0.2393 between 0.08 and 100 Msun (the
    segments' integrals of m^-1.3 and 0.5 m^-2.3)."""
    a = timf.kroupa_imf(20000, torch.Generator().manual_seed(5))
    b = timf.kroupa_imf(20000, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.dtype == torch.float64
    assert float(a.min()) >= 0.08 and float(a.max()) <= 100.0
    frac = float((a > 0.5).double().mean())
    assert abs(frac - 0.2393) < 0.015   # 5 sigma at n = 20,000
    s = timf.salpeter_imf(1000, torch.Generator().manual_seed(5))
    assert float(s.min()) >= 0.4 and float(s.max()) <= 10.0
    with pytest.raises(ValueError, match="m_min"):
        timf.kroupa_imf(4, torch.Generator(), m_min=1.0, m_max=0.5)


@pytest.mark.parametrize("with_masses", [False, True])
def test_king_matches_jax(with_masses):
    """One seed, one IC: the port's King sample equals the JAX package's to
    1e-12 relative (the two differ only in the rounding of the f64 PE sum
    of the Hénon rescale)."""
    n, seed = 512, 2
    masses = (np.random.default_rng(3).uniform(0.2, 5.0, n)
              if with_masses else None)
    kw = dict(total_mass=1.0, G=0.7, r_scale=1.3, masses=masses)
    want = jking.king(n, 6.0, seed=seed, **kw)
    got = tking.king(n, 6.0, seed=seed, device="cpu", **kw)
    for name in ("pos", "vel"):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), ref,
                                   rtol=0, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    assert got.mass.dtype == torch.float32 and got.pos.dtype == torch.float64


def test_plummer_takes_masses_like_jax():
    """Given masses are rescaled to total_mass in f64, then cast to f32."""
    n = 300
    m = np.random.default_rng(4).uniform(0.1, 3.0, n)
    got = t_plummer(n, torch.Generator().manual_seed(1), total_mass=2.5,
                    masses=torch.from_numpy(m)).mass
    want = np.asarray(j_plummer(n, jax.random.PRNGKey(1), total_mass=2.5,
                                masses=m).mass)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -23, atol=0)
    np.testing.assert_allclose(float(got.double().sum()), 2.5, rtol=1e-6)


def test_scene_ics_of_c2_and_c3():
    """c2 builds the JAX package's King IC for its seed; c3 builds a
    Plummer IC with Kroupa masses (mass 1 in Hénon units, the mass
    spectrum's spread) from its own generator."""
    over = ["ic.n=512"]
    cfg_j = jconfig.apply_overrides(jconfig.load_config(C2), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(C2), over)
    want = jscene.build_ic(cfg_j, jscene.build_units(cfg_j))
    got = tscene.build_ic(cfg_t, tscene.build_units(cfg_t), "cpu")
    ref = np.asarray(want.pos)
    np.testing.assert_allclose(got.pos.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())

    cfg = tconfig.apply_overrides(tconfig.load_config(C3), over)
    state = tscene.build_ic(cfg, tscene.build_units(cfg), "cpu")
    m = state.mass.double()
    assert abs(float(m.sum()) - 1.0) < 1e-6
    assert float(m.max() / m.min()) > 50.0
    again = tscene.build_ic(cfg, tscene.build_units(cfg), "cpu")
    assert torch.equal(state.pos, again.pos) and torch.equal(state.mass,
                                                             again.mass)
    equal = tscene.build_ic(
        tconfig.apply_overrides(cfg, ["ic.imf=equal"]),
        tscene.build_units(cfg), "cpu")
    # the IMF has its own stream: the same sample, shifted by the COM
    shift = equal.pos - state.pos
    torch.testing.assert_close(shift, shift[:1].expand_as(shift), rtol=0,
                               atol=1e-12)
