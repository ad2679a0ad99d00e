"""The port's eccentric and inclined orbit placement against the JAX
package's, on identical numpy clusters.

Placement is host f64 arithmetic in both packages (the midplane L² match
of Φ(r_apo) and Φ(r_peri), then a rotation of the orbital plane about x),
so the placed positions and velocities agree to 1e-12 relative: the two
differ only by the rounding of Φ's transcendental functions.
"""
import math

import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.interop import state_from_numpy

from test_torch_slice import REPO, numpy_plummer

C4 = f"{REPO}/configs/c4_block_32k_eccentric.toml"

ORBITS = {
    "c4": [],
    "flat": ["orbit.inclination_deg=0.0"],
    "steep": ["orbit.r_apo_pc=12000.0", "orbit.r_peri_pc=2500.0",
              "orbit.inclination_deg=75.0"],
    "circular_tilted": ["orbit.kind=circular", "orbit.inclination_deg=30.0"],
}


def _both(over):
    cfg_j = jconfig.apply_overrides(jconfig.load_config(C4), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(C4), over)
    us_j, us_t = jscene.build_units(cfg_j), tscene.build_units(cfg_t)
    return (cfg_j, us_j, jscene.build_external_potential(cfg_j, us_j),
            cfg_t, us_t, tscene.build_external_potential(cfg_t, us_t))


@pytest.mark.parametrize("name", list(ORBITS))
def test_place_on_orbit_matches_jax(name):
    cfg_j, us_j, jext, cfg_t, us_t, text = _both(ORBITS[name])
    pos, vel, mass, ids = numpy_plummer(64, seed=3)
    js = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), jext,
                               cfg_j, us_j)
    ts = tscene.place_on_orbit(state_from_numpy(pos, vel, mass, ids, 0.0,
                                                "cpu"), text, cfg_t, us_t)
    for got, want in ((ts.pos, js.pos), (ts.vel, js.vel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    # the centre of mass moved onto the orbit: apocentre, tilted about x
    com = ts.com().numpy()
    if cfg_t.orbit.kind == "eccentric":
        r_apo = cfg_t.orbit.r_apo_pc / us_t.length_pc
        np.testing.assert_allclose(np.linalg.norm(com), r_apo, rtol=1e-12)
    ang = math.radians(cfg_t.orbit.inclination_deg)
    v = ts.com_vel().numpy()
    np.testing.assert_allclose(v[2], v[1] * math.tan(ang),
                               atol=1e-12 * np.abs(v).max())


@pytest.mark.parametrize("apo,peri", [(8000.0, 4000.0), (15000.0, 1000.0),
                                      (6000.0, 5990.0)])
def test_eccentric_orbit_ic_matches_jax(apo, peri):
    cfg_j, us_j, jext, cfg_t, us_t, text = _both([])
    ra, rp = apo / us_t.length_pc, peri / us_t.length_pc
    jpos, jvel = jscene.eccentric_orbit_ic(jext, ra, rp)
    tpos, tvel = tscene.eccentric_orbit_ic(text, ra, rp)
    np.testing.assert_allclose(tpos, np.asarray(jpos), rtol=1e-12)
    np.testing.assert_allclose(tvel, np.asarray(jvel), rtol=1e-12)
    # the orbit's apocentre: tangential, slower than circular there
    assert tvel[0] == tvel[2] == 0.0
    assert 0.0 < tvel[1] < float(text.vcirc(ra))


def test_c4_scene_builds_on_cpu():
    """The c4 config is no longer refused: eccentric orbit, inclination and
    block timesteps all build."""
    cfg = tconfig.apply_overrides(tconfig.load_config(C4), ["ic.n=128"])
    scene = tscene.build_scene(cfg, "cpu")
    stepper, kind = tscene.make_stepper(cfg, scene.force)
    assert kind == "block" and type(stepper).__name__ == "BlockHermite"
    assert (stepper.dt_max, stepper.n_levels, stepper.eta) == (
        1.0 / 64, 8, 0.02)
    assert scene.state.pos.dtype == torch.float64
    assert float(scene.state.com_vel()[2]) > 0.0   # tilted out of the disk
