"""The port's Plummer IC: reproducible from its generator seed, and right
in distribution (its random stream is not JAX's, so it is tested
statistically, as tests/physics/test_cluster.py tests the JAX sampler)."""
import math

import numpy as np
import torch

from oc_nbody_tpu_torch.models.plummer import (A_HENON,
                                               HALF_MASS_RADIUS_OVER_A,
                                               plummer)
from oc_nbody_tpu_torch.ops import gravity


def _ic(n, seed):
    return plummer(n, torch.Generator().manual_seed(seed))


def test_same_seed_same_bits_other_seed_other_bits():
    a, b, c = _ic(512, 4), _ic(512, 4), _ic(512, 5)
    for name in ("pos", "vel", "mass", "ids"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.pos, c.pos)
    assert a.pos.dtype == a.vel.dtype == torch.float64
    assert a.mass.dtype == torch.float32 and a.ids.dtype == torch.int32
    assert a.time == 0.0


def test_plummer_is_virialised_with_the_right_half_mass_radius():
    n = 4096
    s = _ic(n, 11)
    m = s.mass.double()
    ke = 0.5 * float(torch.sum(m * torch.sum(s.vel ** 2, dim=1)))
    _, phi = gravity.accel_potential(s.pos, s.mass, 0.0, 1.0,
                                     compute_dtype=torch.float64, chunk=512)
    pe = 0.5 * float(torch.sum(m * phi))
    assert abs(ke / abs(pe) - 0.5) < 0.05
    r_half = float(torch.median(torch.linalg.norm(s.pos, dim=1)))
    expected = HALF_MASS_RADIUS_OVER_A * A_HENON
    assert abs(r_half / expected - 1.0) < 0.05
    assert math.isclose(HALF_MASS_RADIUS_OVER_A, 1.30477, rel_tol=1e-5)
    np.testing.assert_allclose(s.com().numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(s.com_vel().numpy(), 0.0, atol=1e-12)
    assert math.isclose(float(s.total_mass), 1.0, rel_tol=1e-6)
