"""The f64 pair potential of the diagnostics row (``output.diag_f64``):
``ops/cuda_phi64.py``, K23 (``csrc/phi_f64.cu``) on the card and its plain
twin on the CPU.

On the CPU the wrapper is ``gravity.potential`` in f64 bit for bit, counts
``PLAIN_CALLS["phi_f64"]`` and never ``LAUNCHES``, refuses what K23 does not
take (f32 positions, wrong shapes, non-contiguous inputs) whatever the
device, and is what ``compute_all(..., f64_pairwise=True)`` runs.

On the card (marked ``cuda``, skipped without one; this file imports no
JAX, so run it there with ``-m cuda --noconftest``) K23 is held to the twin
on the same card tensors: N of 1, 2, 127, 128, 4,097 and 131,072 (ragged
row blocks, source tiles and splits), eps > 0 and eps = 0, with coincident
stars for the guard; the largest gap is at most 1e-13 of the larger of
max|phi| and the largest term G m_j / eps (the size of what cancels at N =
1). Two launches give the same bits; each call counts one launch; the
card's f64 row launches K23 once and no twin.
"""
import os

import numpy as np
import pytest
import torch

from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import diagnostics
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import cuda_phi64, gravity
from oc_nbody_tpu_torch.scene import build_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C1 = os.path.join(REPO, "configs", "c1_plummer_1k.toml")
EPS = 1.0 / 512


def _cluster(n, seed, device="cpu", coincident=True):
    """f64 positions off the origin (the port centres them) and the state's
    f32 masses; stars 1 and 2 sit on star 0 where there are four or more,
    and at n = 2 the two coincide."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) + 3.0
    if coincident and n >= 4:
        pos[1:3] = pos[0]
    elif coincident and n == 2:
        pos[1] = pos[0]
    mass = rng.uniform(0.5, 1.5, n) / n
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(mass).float().to(device))


@pytest.mark.parametrize("eps", [0.0, EPS])
@pytest.mark.parametrize("n", [1, 2, 127, 128, 600])
def test_cpu_wrapper_is_the_plain_f64_sum_bit_for_bit(n, eps):
    pos, mass = _cluster(n, n + 3)
    launches, plain = cg.LAUNCHES["phi_f64"], cg.PLAIN_CALLS["phi_f64"]
    got = cuda_phi64.potential(pos, mass, eps, 0.75)
    assert cg.PLAIN_CALLS["phi_f64"] == plain + 1
    assert cg.LAUNCHES["phi_f64"] == launches
    want = gravity.potential(pos, mass, eps, 0.75,
                             compute_dtype=torch.float64, chunk=512)
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("eps", [0.0, EPS])
def test_plain_twin_is_the_f64_pair_potential(eps):
    """The twin's function against the full-broadcast f64 oracle, with the
    self term removed and coincident stars adding nothing at eps = 0."""
    pos, mass = _cluster(300, 11)
    got = cuda_phi64.potential_plain(pos, mass, eps, 0.75)
    _, want = gravity.accel_potential_direct(pos, mass.double(), eps, 0.75)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-13 * scale


@pytest.mark.parametrize("make,err", [
    (lambda p, m: (p.float(), m), TypeError),             # f32 positions
    (lambda p, m: (p, m.to(torch.int32)), TypeError),     # integer masses
    (lambda p, m: (p[:, :2].contiguous(), m), ValueError),  # (n, 2)
    (lambda p, m: (p, m[:-1]), ValueError),               # n - 1 masses
    (lambda p, m: (p.t().contiguous().t(), m), ValueError),  # column-major
    (lambda p, m: (p, torch.stack((m, m), 1)[:, 0]), ValueError),  # strided
])
@pytest.mark.parametrize("fn", ["potential", "potential_kernel"])
def test_wrapper_refuses_what_k23_does_not_take(make, err, fn):
    pos, mass = make(*_cluster(16, 5))
    plain = cg.PLAIN_CALLS["phi_f64"]
    with pytest.raises(err):
        getattr(cuda_phi64, fn)(pos, mass, EPS)
    assert cg.PLAIN_CALLS["phi_f64"] == plain


@pytest.mark.parametrize("f64_pairwise", [True, False])
def test_the_f64_row_goes_through_the_wrapper(monkeypatch, f64_pairwise):
    cfg = tconfig.apply_overrides(tconfig.load_config(C1), ["ic.n=128"])
    scene = build_scene(cfg, "cpu")
    seen = []

    def spy(pos, mass, eps, G=1.0):
        seen.append((pos, mass, eps, G))
        return real(pos, mass, eps, G)

    real = cuda_phi64.potential
    monkeypatch.setattr(cuda_phi64, "potential", spy)
    plain = cg.PLAIN_CALLS["phi_f64"]
    row = diagnostics.compute_all(scene.state, scene.force,
                                  f64_pairwise=f64_pairwise, core=False)
    assert cg.PLAIN_CALLS["phi_f64"] == plain + int(f64_pairwise)
    assert len(seen) == int(f64_pairwise)
    if f64_pairwise:
        pos, mass, eps, G = seen[0]
        assert pos is scene.state.pos and mass is scene.state.mass
        assert (eps, G) == (scene.force.eps, scene.force.G)
        want = gravity.potential(pos, mass, eps, G,
                                 compute_dtype=torch.float64, chunk=512)
        m = mass.double()
        assert float(row["PE_pair"]) == float(0.5 * torch.sum(m * want))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card with "
                    "-m cuda --noconftest)")
    return torch.device("cuda")


def _gap(got, want, mass, eps, G):
    """The largest gap over the larger of max|phi| and the largest term."""
    term = G * float(mass.double().max()) / eps if eps > 0 else 0.0
    scale = max(float(want.abs().max()), term)
    return float((got - want).abs().max()) / scale if scale > 0 else (
        0.0 if torch.equal(got, want) else np.inf)


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.0, EPS])
@pytest.mark.parametrize("n", [1, 2, 127, 128, 4097, 131072])
def test_k23_matches_the_plain_twin(cuda, n, eps):
    pos, mass = _cluster(n, n + 23, cuda)
    got = cuda_phi64.potential_kernel(pos, mass, eps, 0.75)
    want = cuda_phi64.potential_plain(pos, mass, eps, 0.75)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, want, mass, eps, 0.75) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 131072])
def test_k23_repeats_bitwise(cuda, n):
    pos, mass = _cluster(n, 7, cuda)
    launches, plain = cg.LAUNCHES["phi_f64"], cg.PLAIN_CALLS["phi_f64"]
    first = cuda_phi64.potential(pos, mass, EPS)
    assert cg.LAUNCHES["phi_f64"] == launches + 1
    for k in range(2):
        again = cuda_phi64.potential_kernel(pos, mass, EPS)
        assert cg.LAUNCHES["phi_f64"] == launches + 2 + k
        assert torch.equal(first, again)
    assert cg.PLAIN_CALLS["phi_f64"] == plain


@pytest.mark.cuda
def test_the_f64_row_launches_k23_on_the_card(cuda):
    cfg = tconfig.apply_overrides(tconfig.load_config(C1), ["ic.n=1024"])
    scene = build_scene(cfg, "cuda")
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    row = diagnostics.compute_all(scene.state, scene.force,
                                  f64_pairwise=True, core=False)
    torch.cuda.synchronize()
    assert {k: v - launches[k] for k, v in cg.LAUNCHES.items()
            if v != launches[k]} == {"phi_f64": 1}
    assert cg.PLAIN_CALLS == plain
    want = cuda_phi64.potential_plain(scene.state.pos, scene.state.mass,
                                      scene.force.eps, scene.force.G)
    m = scene.state.mass.double()
    pe = float(0.5 * torch.sum(m * want))
    assert abs(float(row["PE_pair"]) - pe) <= 1e-13 * abs(pe)
