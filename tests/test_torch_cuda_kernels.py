"""The CUDA kernels K1 (rows_accel) and K2 (sym_accel) against their plain
PyTorch twins in f64, on the card. Every test here needs an NVIDIA GPU and
nvcc, and skips without them; on the card run

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which that machine does
not have; this file imports no JAX). Sizes cover ragged tiles, both guard
modes and the potential output; tolerances are the JAX package's own
(accel atol 5e-6·max|a|, phi rtol 3e-5).
"""
import numpy as np
import pytest
import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops.gravity import prepare_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card with "
                    "-m cuda --noconftest)")
    return torch.device("cuda")


def _cluster(n, seed, device):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(size=(n, 3))).to(device)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(device)
    return prepare_f32(pos, mass)


def _check(out, ref, with_phi):
    acc, ref_acc = (out[0], ref[0]) if with_phi else (out, ref)
    assert acc.dtype == torch.float32
    err = float((acc.double() - ref_acc).abs().max())
    assert err <= 5e-6 * float(ref_acc.abs().max())
    if with_phi:
        torch.testing.assert_close(out[1].double(), ref[1], rtol=3e-5,
                                   atol=0.0)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("nr,ns", [(1, 1), (127, 129), (1000, 1000),
                                   (300, 4097)])
def test_rows_kernel_matches_plain(cuda, nr, ns, with_phi, eps):
    src, mass = _cluster(ns, ns, cuda)
    rows = (src[:nr] + 0.01).contiguous() if nr != ns else src
    out = cg.rows_kernel(rows, src, mass, eps, 1.3, with_phi=with_phi,
                         guarded=eps == 0.0)
    ref = cg.rows_plain(rows, src, mass, eps, 1.3, with_phi=with_phi,
                        dtype=torch.float64)
    _check(out, ref, with_phi)


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 1000, 8191])
def test_sym_kernel_matches_plain_and_repeats_bitwise(cuda, n, with_phi,
                                                      eps):
    pos, mass = _cluster(n, n, cuda)
    kw = dict(with_phi=with_phi, guarded=eps == 0.0)
    out = cg.sym_kernel(pos, mass, eps, 1.3, **kw)
    again = cg.sym_kernel(pos, mass, eps, 1.3, **kw)
    ref = cg.sym_plain(pos, mass, eps, 1.3, with_phi=with_phi,
                       dtype=torch.float64)
    _check(out, ref, with_phi)
    pairs = zip(out, again) if with_phi else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs)


def test_wrappers_launch_the_kernels_on_cuda(cuda):
    pos, mass = _cluster(8192, 1, cuda)
    pos64 = pos.double()
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    acc, phi = cg.accel_potential(pos64, mass, 1.0 / 64)  # N = SYM_MIN: K2
    cg.accel(pos64[:1000].contiguous(), mass[:1000].contiguous(),
             1.0 / 64)                                     # N < SYM_MIN: K1
    torch.cuda.synchronize()
    assert acc.dtype == phi.dtype == torch.float64
    assert cg.LAUNCHES == {"rows": launches["rows"] + 1,
                           "sym": launches["sym"] + 1}
    assert cg.PLAIN_CALLS == plain


def test_kernel_launchers_check_their_input(cuda):
    pos, mass = _cluster(64, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        cg.rows_kernel(pos.double(), pos, mass, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        cg.sym_kernel(pos.t().contiguous().t(), mass, 0.1)
    with pytest.raises(ValueError, match="shape"):
        cg.rows_kernel(pos, pos, mass[:10], 0.1)
