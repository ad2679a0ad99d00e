"""The port's pairwise-force wrappers (oc_nbody_tpu_torch.ops.cuda_gravity)
against the JAX package on identical inputs.

On the CPU the wrappers run their kernels' plain PyTorch twins. They are
held to the JAX jnp ops, to the Pallas kernels they replace (#1
_accel_kernel, #2 _accel_phi_kernel, #3 _accel_jerk_kernel, #16/#17/#18
_make_sym_kernel with _pair_accel/_pair_phi/_pair_jerk) run in interpret
mode as tests/unit/test_pallas_interpret.py runs them, and to the f64
oracle; K5's twin (rows_jerk_t) to #9 _accel_jerk_kernel_t, reached with
RT_MIN_JERK lowered as test_pallas_interpret.py:372 lowers it. Tolerances are the JAX package's own (test_pallas_interpret.py:
51-59): accel atol 5e-6·max|a|, phi rtol 3e-5; and jerk atol 1e-5·max|j|
(the jerk sums the difference of two terms of one size, so its f32
rounding is about twice the accel's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops.gravity import prepare_f32

G = 1.3
_PALLAS = (pg.accel_rows, pg.accel_potential_rows, pg.accel_sym,
           pg.accel_potential_sym, pg.accel_jerk_rows, pg.accel_jerk_sym,
           pg.accel_jerk_rows_t)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    # several tiles at these small N (the production tile is 512)
    monkeypatch.setattr(pg, "T_SYMA", 128)
    monkeypatch.setattr(pg, "T_SYMP", 128)
    monkeypatch.setattr(pg, "T_SYM", 128)
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


def _moving_cluster(n, seed):
    pos, mass = _cluster(n, seed)
    vel = np.random.default_rng(seed + 1).normal(size=(n, 3)) * 0.5
    return pos, vel, mass


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close_acc(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=5e-6 * np.abs(ref).max(), rtol=0)


def _close_jerk(got, ref):
    """(acc, jerk) against a reference pair."""
    _close_acc(got[0], ref[0])
    ref_j = np.asarray(ref[1], np.float64)
    np.testing.assert_allclose(np.asarray(got[1], np.float64), ref_j,
                               atol=1e-5 * np.abs(ref_j).max(), rtol=0)


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


JERK_CASES = [(n, eps) for n in (257, 512) for eps in (0.0, 1.0 / 64)]


@pytest.mark.parametrize("n,eps", JERK_CASES)
def test_jerk_forms_match_jax(n, eps):
    """accel_jerk (dispatching), accel_jerk_sym and the jerk twins, each
    against the JAX jnp op, the Pallas kernels #3 (one-sided) and #18
    (pair-symmetric) and the f64 oracle."""
    pos, vel, mass = _moving_cluster(n, seed=3 * n)
    guarded = eps == 0.0
    p64, v64, m32 = (_t(pos, torch.float64), _t(vel, torch.float64),
                     _t(mass))
    pc, mc, vc = prepare_f32(p64, m32, vel=v64)
    outs = {
        "accel_jerk": cg.accel_jerk(p64, v64, m32, eps, G, guarded),
        "accel_jerk_sym": cg.accel_jerk_sym(p64, v64, m32, eps, G, guarded),
        "accel_jerk_rows": cg.accel_jerk_rows(pc, vc, pc, vc, mc, eps, G, 0,
                                              guarded),
        "rows_jerk_plain": cg.rows_jerk_plain(pc, vc, pc, vc, mc, eps, G),
        "sym_jerk_plain": cg.sym_jerk_plain(pc, vc, mc, eps, G),
    }
    m32j = jnp.asarray(mass, jnp.float32)
    pcj, mcj, vcj = jgrav.prepare_f32(jnp.asarray(pos), m32j,
                                      vel=jnp.asarray(vel))
    refs = {
        "oracle": jgrav.accel_jerk_direct(pos, vel, mass, eps, G),
        "jnp": jgrav.accel_jerk(pos, vel, m32j, eps, G),
        "pallas #3": pg.accel_jerk_rows(pcj, vcj, pcj, vcj, mcj,
                                        np.float32(eps), np.float32(G),
                                        guarded=guarded),
        "pallas #18": pg.accel_jerk_sym(pos, vel, m32j, eps, G,
                                        guarded=guarded),
    }
    for name, out in outs.items():
        for ref in refs.values():
            _close_jerk(out, ref)
        f32_out = name in ("accel_jerk_rows", "rows_jerk_plain",
                           "sym_jerk_plain")
        want = torch.float32 if f32_out else torch.float64
        assert out[0].dtype == out[1].dtype == want, name


@pytest.mark.parametrize("eps", [0.0, 1.0 / 64])
def test_jerk_rows_from_other_sources_match_jax(eps):
    """accel_jerk_rows with rows != sources (a block stepper's active set)
    against Pallas #3 and the f64 rows oracle."""
    src, svel, mass = _moving_cluster(400, seed=21)
    rows, vrows, _ = _moving_cluster(77, seed=22)
    r32, vr32, s32, sv32, m32 = (np.asarray(a, np.float32)
                                 for a in (rows, vrows, src, svel, mass))
    out = cg.accel_jerk_rows(_t(r32), _t(vr32), _t(s32), _t(sv32), _t(m32),
                             eps, G, 0, eps == 0.0)
    oracle = jgrav.accel_jerk_rows(rows, vrows, src, svel, mass, eps, G)
    pal = pg.accel_jerk_rows(r32, vr32, s32, sv32, m32, np.float32(eps),
                             np.float32(G), guarded=eps == 0.0)
    for ref in (oracle, pal):
        _close_jerk(out, ref)


def test_jerk_oracle_matches_jax_and_guards_the_self_pair():
    """The port's f64 accel_jerk_direct is JAX's to rounding; the f64 jerk
    twins reproduce it; with eps = 0 two particles at one point give zero
    accel and jerk, not NaN."""
    from oc_nbody_tpu_torch.ops import gravity as tgrav
    pos, vel, mass = _moving_cluster(200, seed=31)
    p64, v64, m64 = (_t(a, torch.float64) for a in (pos, vel, mass))
    for eps in (0.0, 0.05):
        got = tgrav.accel_jerk_direct(p64, v64, m64, eps, G)
        ref = jgrav.accel_jerk_direct(pos, vel, mass, eps, G)
        for g_, r_ in zip(got, ref):
            np.testing.assert_allclose(g_.numpy(), np.asarray(r_),
                                       rtol=1e-12, atol=1e-12)
        twin = cg.sym_jerk_plain(p64, v64, m64, eps, G, dtype=torch.float64,
                                 chunk=64)
        for g_, r_ in zip(twin, ref):
            np.testing.assert_allclose(g_.numpy(), np.asarray(r_),
                                       rtol=1e-12, atol=1e-12)
    same = torch.zeros((2, 3), dtype=torch.float64)
    v2 = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], dtype=torch.float64)
    for out in (tgrav.accel_jerk_direct(same, v2, torch.ones(2)),
                cg.accel_jerk(same, v2, torch.ones(2))):
        assert all(bool((t == 0).all()) for t in out)


def test_jerk_dispatch_rule(monkeypatch):
    """K3's twin for RT_MIN_JERK <= N <= STREAM_N, K4's below, and above
    STREAM_N the chunked route (K3's twin on each diagonal chunk, K13's on
    each chunk pair); CPU tensors never count as launches."""
    pos, vel, mass = _moving_cluster(300, seed=41)
    p64, v64, m32 = _t(pos, torch.float64), _t(vel, torch.float64), _t(mass)
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    cg.accel_jerk(p64, v64, m32, 0.1)
    assert cg.PLAIN_CALLS["rows_jerk"] == plain["rows_jerk"] + 1
    monkeypatch.setattr(cg, "RT_MIN_JERK", 300)
    cg.accel_jerk(p64, v64, m32, 0.1)
    assert cg.PLAIN_CALLS["sym_jerk"] == plain["sym_jerk"] + 1
    assert cg.LAUNCHES == launches
    monkeypatch.setattr(cg, "STREAM_N", 299)
    monkeypatch.setattr(cg, "CHUNK_SYMJ", 128)     # chunks 128, 128, 44
    before = dict(cg.PLAIN_CALLS)
    out = cg.accel_jerk(p64, v64, m32, 0.1)
    assert cg.PLAIN_CALLS["sym_jerk"] == before["sym_jerk"] + 3
    assert cg.PLAIN_CALLS["cross_jerk"] == before["cross_jerk"] + 3
    assert cg.LAUNCHES == launches
    _close_jerk(out, jgrav.accel_jerk(pos, vel, np.asarray(mass, np.float32),
                                      0.1))


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
    """sym for SYM_MIN <= N <= STREAM_N, one-sided below, and above
    STREAM_N the chunked route: K2's twin on each diagonal chunk, K12's on
    each chunk pair."""
    pos, mass = _cluster(300, seed=11)
    pos_t, mass_t = _t(pos, torch.float64), _t(mass)
    plain = dict(cg.PLAIN_CALLS)
    cg.accel(pos_t, mass_t, 0.1)
    assert cg.PLAIN_CALLS["rows"] == plain["rows"] + 1
    monkeypatch.setattr(cg, "SYM_MIN", 300)
    cg.accel_potential(pos_t, mass_t, 0.1)
    assert cg.PLAIN_CALLS["sym"] == plain["sym"] + 1
    monkeypatch.setattr(cg, "STREAM_N", 299)
    monkeypatch.setattr(cg, "CHUNK_SYM", 128)      # chunks 128, 128, 44
    before = dict(cg.PLAIN_CALLS)
    acc = cg.accel(pos_t, mass_t, 0.1)
    acc_p, phi = cg.accel_potential(pos_t, mass_t, 0.1)
    assert cg.PLAIN_CALLS["sym"] == before["sym"] + 6
    assert cg.PLAIN_CALLS["cross"] == before["cross"] + 6
    m32 = np.asarray(mass, np.float32)
    ref_acc, ref_phi = jgrav.accel_potential(pos, m32, 0.1)
    _close_acc(acc, ref_acc)
    _close_acc(acc_p, ref_acc)
    _close_phi(phi, ref_phi)


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


@pytest.mark.parametrize("eps", [0.0, 1.0 / 32])
@pytest.mark.parametrize("nr", [1, 37, 200])
def test_k5_twin_matches_transposed_pallas(monkeypatch, nr, eps):
    """accel_jerk_rows at RT_MIN_JERK sources (lowered to 256 in both
    packages) routes to K5's twin in the port and to #9
    _accel_jerk_kernel_t in the JAX package; both agree with each other and
    with the f64 rows oracle."""
    monkeypatch.setattr(cg, "RT_MIN_JERK", 256)
    monkeypatch.setattr(pg, "RT_MIN_JERK", 64)
    src, svel, mass = _moving_cluster(256, seed=51)
    rows, vrows, _ = _moving_cluster(nr, seed=52 + nr)
    r32, vr32, s32, sv32, m32 = (np.asarray(a, np.float32)
                                 for a in (rows, vrows, src, svel, mass))
    plain = dict(cg.PLAIN_CALLS)
    out = cg.accel_jerk_rows(_t(r32), _t(vr32), _t(s32), _t(sv32), _t(m32),
                             eps, G, 0, eps == 0.0)
    assert cg.PLAIN_CALLS["rows_jerk_t"] == plain["rows_jerk_t"] + 1
    assert cg.PLAIN_CALLS["rows_jerk"] == plain["rows_jerk"]
    assert out[0].dtype == out[1].dtype == torch.float32
    assert tuple(out[0].shape) == tuple(out[1].shape) == (nr, 3)
    args = (r32, vr32, s32, sv32, m32, np.float32(eps), np.float32(G))
    refs = {
        "oracle": jgrav.accel_jerk_rows(rows, vrows, src, svel, mass, eps,
                                        G),
        "pallas #9": pg.accel_jerk_rows_t(*args, guarded=eps == 0.0),
        "pallas dispatch": pg.accel_jerk_rows(*args, guarded=eps == 0.0),
    }
    for ref in refs.values():
        _close_jerk(out, ref)


def test_rows_jerk_dispatch_rule(monkeypatch):
    """K5's twin for RT_MIN_JERK <= sources <= STREAM_N with at most
    RT_MAX_ROWS rows, K4's below RT_MIN_JERK sources or above RT_MAX_ROWS
    rows, K14's past STREAM_N sources whatever the row count; CPU tensors
    never count as launches."""
    src, svel, mass = (_t(np.asarray(a, np.float32))
                       for a in _moving_cluster(300, seed=61))
    rows, vrows = src[:40].contiguous(), svel[:40].contiguous()
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)

    def routed(n_src):
        before = dict(cg.PLAIN_CALLS)
        cg.accel_jerk_rows(rows, vrows, src[:n_src].contiguous(),
                           svel[:n_src].contiguous(),
                           mass[:n_src].contiguous(), 0.1)
        return [k for k in before if cg.PLAIN_CALLS[k] != before[k]]

    monkeypatch.setattr(cg, "RT_MIN_JERK", 300)
    assert routed(300) == ["rows_jerk_t"]          # at RT_MIN_JERK
    assert routed(299) == ["rows_jerk"]            # below it
    monkeypatch.setattr(cg, "RT_MIN_JERK", 200)
    assert routed(300) == ["rows_jerk_t"]          # above it
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 39)     # 40 rows: too many
    assert routed(300) == ["rows_jerk"]
    assert cg.LAUNCHES == launches
    assert cg.PLAIN_CALLS["rows_jerk_t"] == plain["rows_jerk_t"] + 2
    monkeypatch.setattr(cg, "STREAM_N", 299)
    assert routed(300) == ["rows_jerk_stream"]     # past STREAM_N, 40 rows
    assert routed(299) == ["rows_jerk"]
    assert cg.LAUNCHES == launches
