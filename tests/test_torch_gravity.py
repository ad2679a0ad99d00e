"""The port's pairwise-force wrappers (oc_nbody_tpu_torch.ops.cuda_gravity)
against the JAX package on identical inputs.

On the CPU the wrappers run their kernels' plain PyTorch twins. They are
held to the JAX jnp ops, to the Pallas kernels they replace (#1
_accel_kernel, #2 _accel_phi_kernel, #16/#17 _make_sym_kernel with
_pair_accel/_pair_phi) run in interpret mode as
tests/unit/test_pallas_interpret.py runs them, and to the f64 oracle.
Tolerances are the JAX package's own (test_pallas_interpret.py:51-59):
accel atol 5e-6·max|a|, phi rtol 3e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu_torch.ops import cuda_gravity as cg

G = 1.3
_PALLAS = (pg.accel_rows, pg.accel_potential_rows, pg.accel_sym,
           pg.accel_potential_sym)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    # several tiles at these small N (the production tile is 512)
    monkeypatch.setattr(pg, "T_SYMA", 128)
    monkeypatch.setattr(pg, "T_SYMP", 128)
    for fn in _PALLAS:
        fn.clear_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    for fn in _PALLAS:
        fn.clear_cache()


def _cluster(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, mass


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close_acc(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=5e-6 * np.abs(ref).max(), rtol=0)


def _close_phi(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=3e-5)


CASES = [(n, eps) for n in (257, 300, 512) for eps in (0.0, 1.0 / 64)]


@pytest.mark.parametrize("n,eps", CASES)
def test_rows_forms_match_jax(n, eps):
    """accel_rows / accel_potential_rows with rows != sources."""
    src, mass = _cluster(n, seed=n)
    rows, _ = _cluster(n // 3 + 5, seed=n + 1)
    r32, s32, m32 = (np.asarray(a, np.float32) for a in (rows, src, mass))
    acc = cg.accel_rows(_t(r32), _t(s32), _t(m32), eps, G)
    acc2, phi = cg.accel_potential_rows(_t(r32), _t(s32), _t(m32), eps, G)
    assert acc.dtype == phi.dtype == torch.float32

    oracle_acc, oracle_phi = jgrav.accel_potential_rows(rows, src, mass,
                                                        eps, G)  # f64
    jnp_acc, jnp_phi = jgrav.accel_potential_rows(r32, s32, m32,
                                                  np.float32(eps),
                                                  np.float32(G))
    pal_acc = pg.accel_rows(r32, s32, m32, np.float32(eps), np.float32(G),
                            guarded=eps == 0.0)
    pal_acc2, pal_phi = pg.accel_potential_rows(
        r32, s32, m32, np.float32(eps), np.float32(G), guarded=eps == 0.0)
    for ref in (oracle_acc, jnp_acc, pal_acc, pal_acc2):
        _close_acc(acc, ref)
        _close_acc(acc2, ref)
    for ref in (oracle_phi, jnp_phi, pal_phi):
        _close_phi(phi, ref)


@pytest.mark.parametrize("n,eps", CASES)
def test_self_forms_match_jax(n, eps):
    """accel / accel_potential (dispatching) and the sym forms, each
    against the jnp ops, the Pallas sym kernels and the f64 oracle; the
    potential has the self term removed."""
    pos, mass = _cluster(n, seed=2 * n)
    pos_t, mass_t = _t(pos, torch.float64), _t(mass, torch.float32)
    guarded = eps == 0.0
    outs = {
        "accel": (cg.accel(pos_t, mass_t, eps, G, guarded), None),
        "accel_potential": cg.accel_potential(pos_t, mass_t, eps, G,
                                              guarded),
        "accel_sym": (cg.accel_sym(pos_t, mass_t, eps, G, guarded), None),
        "accel_potential_sym": cg.accel_potential_sym(pos_t, mass_t, eps, G,
                                                      guarded),
    }
    m32 = jnp.asarray(mass, jnp.float32)
    oracle = jgrav.accel_potential_direct(pos, mass, eps, G)
    jnp_ref = jgrav.accel_potential(pos, m32, eps, G)
    pal_a = pg.accel_sym(pos, m32, eps, G, guarded=guarded)
    pal_ap = pg.accel_potential_sym(pos, m32, eps, G, guarded=guarded)
    for name, (acc, phi) in outs.items():
        assert acc.dtype == torch.float64, name
        for ref_acc in (oracle[0], jnp_ref[0], pal_a, pal_ap[0]):
            _close_acc(acc, ref_acc)
        if phi is not None:
            assert phi.dtype == torch.float64, name
            for ref_phi in (oracle[1], jnp_ref[1], pal_ap[1]):
                _close_phi(phi, ref_phi)


def test_plain_twins_in_f64_match_the_oracle():
    """The f64 plain twins — the reference the kernels are held to on the
    card — reproduce the JAX f64 oracle to rounding."""
    pos, mass = _cluster(300, seed=7)
    p64, m64 = _t(pos, torch.float64), _t(mass, torch.float64)
    acc, phi = cg.sym_plain(p64, m64, 0.05, G, with_phi=True,
                            dtype=torch.float64, chunk=64)
    ref_acc, ref_phi = jgrav.accel_potential_direct(pos, mass, 0.05, G)
    ref_phi = np.asarray(ref_phi) - np.asarray(
        jgrav.self_phi(jnp.asarray(mass), 0.05, G))   # rows form keeps it
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(phi.numpy(), ref_phi, rtol=1e-12)
    acc_r = cg.rows_plain(p64[:50], p64, m64, 0.05, G, dtype=torch.float64)
    np.testing.assert_allclose(acc_r.numpy(), np.asarray(ref_acc)[:50],
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_touch_the_launch_counters():
    pos, mass = _cluster(300, seed=9)
    pos_t, mass_t = _t(pos, torch.float64), _t(mass)
    p32 = _t(pos)
    launches = dict(cg.LAUNCHES)
    plain = dict(cg.PLAIN_CALLS)
    cg.accel_rows(p32, p32, mass_t, 0.1)
    cg.accel_potential_rows(p32, p32, mass_t, 0.1)
    cg.accel_sym(pos_t, mass_t, 0.1)
    cg.accel_potential_sym(pos_t, mass_t, 0.1)
    cg.accel(pos_t, mass_t, 0.1)
    cg.accel_potential(pos_t, mass_t, 0.1)
    assert cg.LAUNCHES == launches
    assert cg.PLAIN_CALLS["rows"] == plain["rows"] + 4
    assert cg.PLAIN_CALLS["sym"] == plain["sym"] + 2


def test_dispatch_rule(monkeypatch):
    """sym for SYM_MIN <= N <= STREAM_N, one-sided below, ValueError
    naming ROADMAP B5 above."""
    pos, mass = _cluster(300, seed=11)
    pos_t, mass_t = _t(pos, torch.float64), _t(mass)
    plain = dict(cg.PLAIN_CALLS)
    cg.accel(pos_t, mass_t, 0.1)
    assert cg.PLAIN_CALLS["rows"] == plain["rows"] + 1
    monkeypatch.setattr(cg, "SYM_MIN", 300)
    cg.accel_potential(pos_t, mass_t, 0.1)
    assert cg.PLAIN_CALLS["sym"] == plain["sym"] + 1
    monkeypatch.setattr(cg, "STREAM_N", 299)
    with pytest.raises(ValueError, match="B5"):
        cg.accel(pos_t, mass_t, 0.1)
    with pytest.raises(ValueError, match="B5"):
        cg.accel_potential(pos_t, mass_t, 0.1)


def test_no_nvcc_means_no_kernels(monkeypatch, tmp_path):
    """Without nvcc the kernel library cannot be built, and loading it
    raises: there is no silent fallback for CUDA tensors."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cg, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cg, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cg.build_library()
    with pytest.raises(RuntimeError, match="nvcc"):
        cg._library()
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_mixed_devices():
    pos, mass = _cluster(16, seed=3)
    p32 = _t(pos)
    with pytest.raises(ValueError, match="device"):
        cg.accel_rows(p32, p32.to("meta"), _t(mass), 0.1)


def test_port_oracles_and_blocked_ops_match_jax():
    """The port's ops/gravity.py: the f64 direct oracles to rounding, and
    the blocked f32 wrappers to f32 summation order, against JAX's."""
    from oc_nbody_tpu_torch.ops import gravity as tgrav
    pos, mass = _cluster(200, seed=13)
    p64, m64 = _t(pos, torch.float64), _t(mass, torch.float64)
    np.testing.assert_allclose(tgrav.accel_direct(p64, m64, 0.05, G).numpy(),
                               np.asarray(jgrav.accel_direct(pos, mass, 0.05,
                                                             G)),
                               rtol=1e-12, atol=1e-12)
    for eps in (0.0, 0.05):
        acc, phi = tgrav.accel_potential_direct(p64, m64, eps, G)
        ref_acc, ref_phi = jgrav.accel_potential_direct(pos, mass, eps, G)
        np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi),
                                   rtol=1e-12)
    m32 = _t(mass)
    _close_acc(tgrav.accel(p64, m32, 0.05, G, chunk=64),
               jgrav.accel(pos, np.asarray(mass, np.float32), 0.05, G))
    acc, phi = tgrav.accel_potential(p64, m32, 0.05, G, chunk=64)
    ref_acc, ref_phi = jgrav.accel_potential(pos, np.asarray(mass, np.float32),
                                             0.05, G)
    _close_acc(acc, ref_acc)
    _close_phi(phi, ref_phi)
