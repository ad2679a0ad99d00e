"""The plain float64 reference against the program's plain twins and the
program's Milky Way, at N = 512 on the CPU."""
import math

import torch
import pytest

from bench_torch import units
from bench_torch.reference import direct, orbit
from bench_torch.reference.milky_way import MilkyWay
from oc_nbody_tpu_torch.models import potentials
from oc_nbody_tpu_torch.ops import cuda_gravity

F64 = torch.float64


def _cluster(n=512, seed=3):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn((n, 3), generator=g, dtype=F64)
    vel = 0.3 * torch.randn((n, 3), generator=g, dtype=F64)
    mass = torch.rand((n,), generator=g, dtype=F64) / n
    return pos, vel, mass.to(torch.float32)


def test_direct_sum_matches_the_plain_twin_in_float64():
    pos, vel, mass = _cluster()
    eps, G = 1.0 / 256, 1.0
    acc, phi, jerk = direct.pair_sums(pos, mass, eps, G, vel=vel, block=100)
    pc = pos - pos.mean(dim=0)
    vc = vel - vel.mean(dim=0)
    a_tw, phi_tw = cuda_gravity.rows_plain(pc, pc, mass, eps, G,
                                           with_phi=True, dtype=F64)
    phi_tw = phi_tw + G * mass.to(F64) / eps      # the twin keeps i == j
    a_j, j_tw = cuda_gravity.rows_jerk_plain(pc, vc, pc, vc, mass, eps, G,
                                             dtype=F64)
    scale = acc.abs().max()
    assert (acc - a_tw).abs().max() / scale < 1e-13
    assert (acc - a_j).abs().max() / scale < 1e-13
    assert (phi - phi_tw).abs().max() / phi.abs().max() < 1e-13
    assert (jerk - j_tw).abs().max() / jerk.abs().max() < 1e-13


def test_bfloat16_control_is_far_from_the_reference():
    pos, _, mass = _cluster()
    acc, _, _ = direct.pair_sums(pos, mass, 1.0 / 256, 1.0)
    low, _, _ = direct.pair_sums(pos, mass, 1.0 / 256, 1.0,
                                 dtype=torch.bfloat16,
                                 sum_dtype=torch.float32)
    assert (low - acc).norm(dim=1).max() / acc.norm(dim=1).max() > 1e-3


def test_energies_by_hand():
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0]], dtype=F64)
    vel = torch.tensor([[0.0, 1, 0], [0.0, -1, 0]], dtype=F64)
    mass = torch.tensor([1.0, 1.0])
    _, phi, _ = direct.pair_sums(pos, mass, 0.0, 1.0)
    e = direct.energies(pos, vel, mass, phi)
    assert e["KE"] == pytest.approx(1.0)
    assert e["PE_pair"] == pytest.approx(-1.0)
    assert e["E_int"] == pytest.approx(0.0)


def test_milky_way_accel_is_minus_grad_phi_and_matches_the_program():
    G, _ = units.henon({"kind": "henon", "mass_msun": 50000.0,
                        "length_pc": 10.0})
    mw = MilkyWay(G=G, msun=1 / 50000.0, pc=1 / 10.0)
    x = torch.tensor([[800.0, 3.0, -2.0], [400.0, -50.0, 30.0],
                      [-20.0, 600.0, 5.0]], dtype=F64, requires_grad=True)
    grad, = torch.autograd.grad(mw.phi(x).sum(), x)
    a = mw.accel(x.detach())
    assert torch.allclose(a, -grad, rtol=1e-12, atol=0)
    prog = potentials.milky_way(G, 1 / 50000.0, 1 / 10.0)
    assert torch.allclose(mw.phi(x.detach()), prog.phi(x.detach()),
                          rtol=1e-14, atol=0)
    assert torch.allclose(a, prog.accel(x.detach()), rtol=1e-12, atol=0)


def test_henon_units_give_unit_G():
    G, t_myr = units.henon({"kind": "henon", "mass_msun": 50000.0,
                            "length_pc": 10.0})
    assert G == pytest.approx(1.0, rel=1e-14)
    assert t_myr == pytest.approx(2.109, rel=1e-3)


def test_orbit_keeps_a_circular_orbit():
    G, _ = units.henon({"kind": "henon", "mass_msun": 50000.0,
                        "length_pc": 10.0})
    mw = MilkyWay(G=G, msun=1 / 50000.0, pc=1 / 10.0)
    r = 800.0
    a = float(mw.accel(torch.tensor([[r, 0.0, 0.0]], dtype=F64))[0, 0])
    vc = math.sqrt(-a * r)
    x, v = orbit.integrate(mw, [r, 0, 0], [0, vc, 0], 5.0)
    assert float(x.norm()) == pytest.approx(r, rel=1e-10)
    assert float(v.norm()) == pytest.approx(vc, rel=1e-10)


def _row_state(n=512, seed=4):
    """A Plummer-like cluster on a circular orbit 800 code lengths out."""
    g = torch.Generator().manual_seed(seed)
    r = 0.6 / torch.sqrt(torch.rand(n, generator=g, dtype=F64) ** (-2 / 3)
                         - 1)
    u = torch.randn((n, 3), generator=g, dtype=F64)
    pos = r[:, None] * u / u.norm(dim=1, keepdim=True)
    vel = 0.4 * torch.randn((n, 3), generator=g, dtype=F64)
    pos = pos + torch.tensor([800.0, 0.0, 0.0], dtype=F64)
    vel = vel + torch.tensor([0.0, 45.0, 0.0], dtype=F64)
    return pos, vel, torch.full((n,), 1.0 / n, dtype=torch.float32)


def test_row_structure_matches_the_program_row():
    from bench_torch.reference import row
    from oc_nbody_tpu_torch import diagnostics
    from oc_nbody_tpu_torch.forces import ForceModel
    from oc_nbody_tpu_torch.state import ParticleState
    G, _ = units.henon({"kind": "henon", "mass_msun": 5e4, "length_pc": 10})
    field = MilkyWay(G=G, msun=1 / 5e4, pc=0.1)
    pos, vel, mass = _row_state()
    eps = 1.0 / 512
    force = ForceModel(eps=eps, G=G, external=potentials.milky_way(
        G, mass_scale=1 / 5e4, length_scale=0.1))
    state = ParticleState(pos=pos, vel=vel, mass=mass,
                          ids=torch.arange(512, dtype=torch.int32), time=0.0)
    got = diagnostics.compute_all(state, force)
    fr = (0.1, 0.25, 0.5, 0.75, 0.9)
    ref = row.structure(pos, vel, mass, field, G, eps, fr)
    assert ref["N_bound"] == int(got["N_bound"]) < 512   # a tidal cut
    assert ref["M_bound"] == pytest.approx(float(got["M_bound"]), rel=1e-14)
    assert ref["r_tidal"] == pytest.approx(float(got["r_tidal"]), rel=1e-12)
    for f, r in zip(fr, ref["r_lagr"]):
        assert r == pytest.approx(float(got[f"r_lagr_{round(f * 100)}"]),
                                  rel=1e-12)
    # the program's CH85 distances are float32
    assert ref["r_core"] == pytest.approx(float(got["r_core"]), rel=1e-5)
    assert ref["rho_core"] == pytest.approx(float(got["rho_core"]), rel=1e-5)
    low = row.structure(pos, vel, mass, field, G, eps, fr,
                        dtype=torch.bfloat16, sum_dtype=torch.float32)
    assert abs(low["r_core"] / ref["r_core"] - 1) > 1e-4
    assert max(abs(a / b - 1) for a, b in zip(low["r_lagr"],
                                              ref["r_lagr"])) > 1e-4


def test_row_structure_without_a_field_matches_the_program_row():
    """An isolated cluster: the program's energy cut, no tidal radius."""
    from bench_torch.reference import row
    from oc_nbody_tpu_torch import diagnostics
    from oc_nbody_tpu_torch.forces import ForceModel
    from oc_nbody_tpu_torch.state import ParticleState
    G, eps = 1.0, 1.0 / 256
    pos, vel, mass = _row_state()
    vel = (vel - vel.mean(dim=0)) * 3.0       # some stars escape
    force = ForceModel(eps=eps, G=G)
    state = ParticleState(pos=pos, vel=vel, mass=mass,
                          ids=torch.arange(512, dtype=torch.int32), time=0.0)
    got = diagnostics.compute_all(state, force)
    _, phi, _ = direct.pair_sums(pos, mass, eps, G)
    fr = (0.1, 0.25, 0.5, 0.75, 0.9)
    ref = row.structure(pos, vel, mass, None, G, eps, fr, phi_pair=phi)
    assert 0 < ref["N_bound"] == int(got["N_bound"]) < 512
    assert ref["M_bound"] == pytest.approx(float(got["M_bound"]), rel=1e-14)
    assert ref["r_tidal"] == float(got["r_tidal"]) == math.inf
    for f, r in zip(fr, ref["r_lagr"]):
        assert r == pytest.approx(float(got[f"r_lagr_{round(f * 100)}"]),
                                  rel=1e-12)
    assert ref["r_core"] == pytest.approx(float(got["r_core"]), rel=1e-5)


def test_core_density_by_hand():
    """Seven stars: six on a sphere of radius 1 about one at the centre.
    The centre's 6th neighbour is at 1, five of them weigh 5 m."""
    from bench_torch.reference import row
    pos = torch.tensor([[0.0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [0, -1, 0], [0, 0, 1], [0, 0, -1],
                        [0.0, 0, 9.0]], dtype=F64)
    mass = torch.ones(8, dtype=F64)
    x = pos - pos.mean(dim=0)
    c = x[0]
    bound = torch.tensor([True] + [False] * 7)
    r_core, rho_core = row._core(x, mass, c, bound, 0.01, F64, F64, 4)
    rho0 = 5.0 / (4 * math.pi / 3)
    assert r_core == pytest.approx(0.0, abs=1e-12)
    assert rho_core == pytest.approx(rho0, rel=1e-12)
