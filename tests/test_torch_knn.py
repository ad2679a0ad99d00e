"""CH85's k-th-nearest-neighbour sweep (``ops/cuda_knn.py``) on the CPU:
the plain twin that K22 is held to on the card, pinned on integer-lattice
positions, where every f32 d² is exact whatever the order of its sums.
There the twin's (rk2, mnb) equal a direct definition of the tie rules
(the k-th smallest distinct positive d², the mass of the pairs at a
positive d² at or inside the (k-1)-th; with fewer than k - 1 distinct
positive distances, every source's mass, the excluded pairs' too), and
``diagnostics.local_density`` equals the JAX package's: duplicate ranks,
tied masses, coincident stars, fewer than k distinct distances, strided
probes and sources, and the ``r_min`` floor. Masses are multiples of 1/8,
so their f32 sums are exact in any order too."""
import numpy as np
import pytest
import torch

from oc_nbody_tpu import diagnostics as jdiag
from oc_nbody_tpu_torch import diagnostics as tdiag
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import cuda_knn

CASES = {
    # 300 draws from a 7³ lattice: coincident stars, ranks shared by many
    # sources of different masses
    "ties": dict(n=300, side=3),
    # the same, strided: probes 5 apart, sources 3 apart (masses x 3)
    "ties_strided": dict(n=300, side=3, max_probes=64, max_sources=100),
    # eight stars on a line, one coincident pair: probes with 6, 5 and 3
    # distinct positive distances
    "line": dict(pos=[[i, 0, 0] for i in range(7)] + [[3, 0, 0]]),
    # two points of 6 stars each: one distinct positive distance
    "two_points": dict(pos=[[0, 0, 0]] * 6 + [[1, 0, 0]] * 6),
}


def lattice(case, seed=7):
    """(pos, mass) float64 numpy arrays of a CASES entry, and its strides'
    caps."""
    spec = CASES[case]
    rng = np.random.default_rng(seed)
    if "pos" in spec:
        pos = np.asarray(spec["pos"], dtype=np.float64)
    else:
        side = spec["side"]
        pos = rng.integers(-side, side + 1, size=(spec["n"], 3)).astype(
            np.float64)
    mass = rng.integers(1, 9, size=pos.shape[0]) / 8.0
    caps = {key: spec.get(key, 65536) for key in ("max_probes",
                                                  "max_sources")}
    return pos, mass, caps


def direct(probes, src, msrc, k):
    """The tie rules spelled out per probe, in f64 on exact values."""
    d2 = ((probes[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    rk2, mnb = [], []
    for row in d2:
        ranks = np.unique(row[row > 0])
        rk2.append(ranks[k - 1] if ranks.size >= k else np.inf)
        mnb.append(msrc[(row > 0) & (row <= ranks[k - 2])].sum()
                   if ranks.size >= k - 1 else msrc.sum())
    return np.array(rk2), np.array(mnb)


@pytest.mark.parametrize("k,r_min", [(6, 0.0), (6, 2.5), (3, 0.0)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_twin_keeps_the_jax_tie_semantics(case, k, r_min):
    pos, mass, caps = lattice(case)
    ps = -(-pos.shape[0] // caps["max_probes"])
    ss = -(-pos.shape[0] // caps["max_sources"])
    probes = torch.from_numpy(pos[::ps]).float()
    src = torch.from_numpy(pos[::ss]).float()
    msrc = torch.from_numpy(mass[::ss]).float() * float(ss)
    calls = cg.PLAIN_CALLS["knn_density"]
    rk2, mnb = cuda_knn.knn_density(probes, src, msrc, k, chunk=5)
    assert cg.PLAIN_CALLS["knn_density"] == calls + 1
    want_rk2, want_mnb = direct(pos[::ps], pos[::ss], msrc.double().numpy(),
                                k)
    np.testing.assert_array_equal(rk2.double().numpy(), want_rk2)
    np.testing.assert_array_equal(mnb.double().numpy(), want_mnb)

    center = np.zeros(3)
    rho, tps = tdiag.local_density(
        torch.from_numpy(pos), torch.from_numpy(mass),
        torch.from_numpy(center), k=k, r_min=r_min, **caps)
    jrho, jps = jdiag.local_density(pos, mass, center, k=k, r_min=r_min,
                                    **caps)
    assert tps == jps == ps
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-15,
                               atol=0.0)
    floored = want_rk2 < np.float32(r_min) ** 2
    if r_min > 0 and case.startswith("ties"):
        assert floored.any()    # the floor binds somewhere
    if case == "two_points" or (case == "line" and k == 6):
        assert np.isinf(want_rk2).any()   # fewer than k distinct distances


def test_kernel_wrapper_refuses_an_uncompiled_k():
    p = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="compiled for k"):
        cuda_knn.knn_density_kernel(p, p, torch.ones(4), 5)
