"""Escape pruning in the port (``oc_nbody_tpu_torch/escape.py``, the pruned
ForceModel, K18's and K19's plain twins and the rows dispatch) against the
JAX package on identical inputs, on the CPU at small size.

  * ``escape``: ``build_sources`` bitwise the JAX function's on random
    masks, with no cluster, with 2B >= N and with ``min_bucket`` above the
    cluster; ``next_pow2``; ``partition_inputs`` and ``cluster_mask`` on the
    same orbiting state (centre to 1e-12, r_t rtol 1e-10, masks equal);
  * K18's twin (``rows_plain`` counted as K18's) against the
    Pallas kernels #7/#8 (``accel_rows_t``, ``accel_potential_rows_t``) and
    #4/#5 (``accel_rows_streamed``, ``accel_potential_rows_streamed``,
    compensated) in interpret mode, and K19's (``rows_x_stream_plain``)
    against #13/#14 through ``accel_rows_x_hilo`` and
    ``accel_potential_rows_x_hilo`` with RT_MAX_ROWS lowered in both
    packages; ragged shapes, eps = 0 (guarded, rows that are sources) and
    eps > 0; held to 5e-6·max|a| and phi rtol 3e-5, the f64 twins to the
    f64 oracle;
  * the dispatch: with STREAM_N, RT_MIN_ACCEL and RT_MAX_ROWS lowered in
    both packages, the port's rows wrappers reach K1, K18, K18<comp>, K8 or
    K19 on exactly the (rows, sources) grid where the JAX package's reach
    #1/#2, #7/#8, #4/#5, #10/#11 or #13/#14 (the kernel JAX hands to
    ``pallas_call`` is caught before it runs);
  * the pruned ForceModel at the f32 and the extended tier against the JAX
    package's (its jnp backend) and both against the f64 oracle of the
    reduced Hamiltonian (the statement of tests/unit/test_escape_prune.py):
    accel; accel, phi and E_tot with the self-term cancel (the energies'
    uniform ½ weight sums the mixed phi to PE_CC + PE_CT); accel + jerk;
    ``accel_jerk_on_rows`` on all-cluster, all-tail, mixed and 0.5-fill
    rows; and the refusals (df32; no external potential, ``diag_f64`` and
    df32 in ``run``).

Tolerances: port against JAX 5e-6·max|a|, 1e-5·max|j|, phi rtol 3e-5 (the
standing f32 bounds, tests/test_torch_gravity.py); against the oracle the
JAX test's own (f32 2e-6 of max|a|, 5e-6 of max|j|, E_tot 1e-6; extended
3e-7, 1e-6, E_tot 4e-7).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import diagnostics as jdiag
from oc_nbody_tpu import escape as jescape
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import diagnostics as tdiag
from oc_nbody_tpu_torch import escape as tescape
from oc_nbody_tpu_torch import run as trun
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from test_torch_slice import REPO, numpy_plummer

N, EPS = 512, 1.0 / 64
_PALLAS = (pg.accel_rows, pg.accel_potential_rows, pg.accel_rows_t,
           pg.accel_potential_rows_t, pg.accel_rows_streamed,
           pg.accel_potential_rows_streamed, pg.accel_rows_x_hilo,
           pg.accel_potential_rows_x_hilo)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    for fn in _PALLAS:
        fn.clear_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    for fn in _PALLAS:
        fn.clear_cache()


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _rel(got, want, vector=True):
    """max row error over max row size (norms for vectors)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vector:
        return (np.linalg.norm(got - want, axis=1).max()
                / np.linalg.norm(want, axis=1).max())
    return np.abs(got - want).max() / np.abs(want).max()


def _ran(before):
    return {k for k in cg.PLAIN_CALLS if cg.PLAIN_CALLS[k] != before[k]}


# --------------------------------------------------------------------------
# escape.py
# --------------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(7)
    out = [rng.uniform(size=n) < p for n, p in ((1000, 0.1), (777, 0.03),
                                                 (4096, 0.2))]
    out.append(np.zeros(300, bool))                    # no cluster
    heavy = np.zeros(300, bool)
    heavy[:100] = True                                 # 2B = 256 < 300
    out.append(heavy)
    heavy2 = np.zeros(300, bool)
    heavy2[:129] = True                                # B = 256: 2B >= N
    out.append(heavy2)
    return out


@pytest.mark.parametrize("min_bucket", [1, 16, 128, 2048])
def test_build_sources_is_bitwise_the_jax_function(min_bucket):
    for mask in _masks():
        got = tescape.build_sources(mask, min_bucket)
        want = jescape.build_sources(mask, min_bucket)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]
    for n in (0, 1, 2, 3, 5, 64, 65, 1000, 1 << 20, (1 << 20) + 1):
        assert tescape.next_pow2(n) == jescape.next_pow2(n)
    # min_bucket above the cluster, and the bucket past N/2
    mask = np.zeros(1000, bool)
    mask[3:10] = True
    assert tescape.build_sources(mask, 128)[0].shape == (128,)
    assert tescape.build_sources(mask, 512) is None


def _orbit_state(n=512, seed=3):
    """The same orbiting cluster in both packages: the over-tidal scenario
    of tests/unit/test_escape_prune.py (500 Msun at 8 pc on a 4 kpc orbit)
    from a numpy Plummer sample, placed by each package's scene."""
    d = {"units": {"kind": "henon", "mass_msun": 500.0, "length_pc": 8.0},
         "ic": {"kind": "plummer", "n": n, "seed": seed},
         "potential": {"kind": "milky_way"},
         "orbit": {"kind": "circular", "R0_pc": 4000.0},
         "integrator": {"eps": EPS}}
    cj, ct = jconfig.SimConfig.from_dict(d), tconfig.SimConfig.from_dict(d)
    pos, vel, mass, ids = numpy_plummer(n, seed)
    us = jscene.build_units(cj)
    ext = jscene.build_external_potential(cj, us)
    js = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext, cj, us)
    jf = j_make_force_model(EPS, us.G, ext, backend="jnp")
    tus = tscene.build_units(ct)
    text = tscene.build_external_potential(ct, tus)
    ts = tscene.place_on_orbit(state_from_numpy(pos, vel, mass, ids, 0.0,
                                                "cpu"), text, ct, tus)
    tf = t_make_force_model(EPS, tus.G, text)
    return js, jf, ts, tf


def test_partition_inputs_and_cluster_mask_match_jax():
    js, jf, ts, tf = _orbit_state()
    jc, jrt = jescape.partition_inputs(js, jf)
    tc, trt = tescape.partition_inputs(ts, tf)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(float(trt), float(jrt), rtol=1e-10)
    assert np.isfinite(float(trt))
    for r_cut in (0.5, 1.5, np.inf):
        jm = np.asarray(jescape.cluster_mask(js, jc, float(jrt) * r_cut))
        tm = tescape.cluster_mask(ts, tc, float(trt) * r_cut).numpy()
        np.testing.assert_array_equal(tm, jm)
        assert tm.dtype == bool
    assert 0 < int(tm.sum()) == len(tm)            # r_cut = inf keeps all


# --------------------------------------------------------------------------
# K18 and K19: the twins against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def _rows_case(nr, ns, eps, seed):
    """Centred f32 (rows, src, mass) numpy: rows overlap the first sources
    when eps == 0 (the guarded self pair), else are shifted off them."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(ns, 3))
    mass = rng.uniform(0.5, 1.5, ns) / ns
    rows = src[np.arange(nr) % ns]
    rows = rows if eps == 0 else rows + 0.01
    c = src.mean(axis=0)
    return ((rows - c).astype(np.float32), (src - c).astype(np.float32),
            mass.astype(np.float32))


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("phi", [False, True])
@pytest.mark.parametrize("form", ["t", "stream"])
def test_k18_twins_match_the_pallas_kernels(form, phi, eps):
    """#7/#8 (transposed, resident) and #4/#5 (streamed, compensated) on
    300 rows x 4,500 sources (ragged against every tile)."""
    G = 1.3
    rows, src, mass = _rows_case(300, 4500, eps, 11)
    tr, ts_, tm = _t(rows, src, mass)
    key = "rows_t" if form == "t" else "rows_stream"
    before = dict(cg.PLAIN_CALLS)
    got = cg.rows_plain(tr, ts_, tm, eps, G, with_phi=phi, key=key)
    assert _ran(before) == {key}
    f32 = np.float32
    args = (rows, src, mass, f32(eps), f32(G))
    if form == "t":
        fn = pg.accel_potential_rows_t if phi else pg.accel_rows_t
        want = fn(*args, guarded=eps == 0)
    else:
        fn = (pg.accel_potential_rows_streamed if phi
              else pg.accel_rows_streamed)
        want = fn(*args, guarded=eps == 0, compensated=True)
    ref = cg.rows_plain(tr, ts_, tm, eps, G, with_phi=phi,
                        dtype=torch.float64, key=key)
    oracle = jgrav.accel_potential_rows(rows.astype(np.float64),
                                        src.astype(np.float64),
                                        mass.astype(np.float64), eps, G, 64)
    got, want, ref = ((x if phi else (x,)) for x in (got, want, ref))
    assert got[0].dtype == torch.float32 and ref[0].dtype == torch.float64
    assert _rel(got[0], want[0]) < 5e-6
    assert _rel(ref[0], oracle[0]) < 1e-12
    assert _rel(got[0], oracle[0]) < 5e-6
    if phi:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=3e-5)
        np.testing.assert_allclose(ref[1].numpy(), np.asarray(oracle[1]),
                                   rtol=1e-12)


def _planes(nr, ns, eps, seed):
    """(rhi, rlo, shi, slo, gm) numpy planes 8 kpc out under one centring
    (the sources' mean); rows overlap the first sources at eps == 0."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(ns, 3)) + [8000.0, 0.0, -3.0]
    rows = src[np.arange(nr) % ns]
    rows = rows if eps == 0 else rows + 0.01
    c = src.mean(axis=0)
    out = []
    for x in (rows - c, src - c):
        hi = x.astype(np.float32)
        out += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    gm = (1.3 * rng.uniform(0.5, 1.5, ns) / ns).astype(np.float32)
    return (*out, gm), rows, src


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("phi", [False, True])
@pytest.mark.parametrize("nr,ns", [(300, 2048), (200, 4500)])
def test_k19_twin_matches_the_pallas_kernels(monkeypatch, nr, ns, phi, eps):
    """#13/#14 (streamed extended, Kahan on accel and phi) through the
    public rows forms of both packages, RT_MAX_ROWS lowered below the row
    count in both, so that each takes its streamed kernel (K19's twin)."""
    monkeypatch.setattr(pg, "RT_MAX_ROWS", 128)
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 128)
    for fn in _PALLAS:
        fn.clear_cache()
    planes, rows, src = _planes(nr, ns, eps, 13)
    tp = _t(*planes)
    g = dict(guarded=eps == 0)
    before = dict(cg.PLAIN_CALLS)
    if phi:
        got = cg.accel_potential_rows_x_hilo(*tp, eps, **g)
        want = pg.accel_potential_rows_x_hilo(*planes, np.float32(eps), **g)
    else:
        got = (cg.accel_rows_x_hilo(*tp, eps, **g),)
        want = (pg.accel_rows_x_hilo(*planes, np.float32(eps), **g),)
    assert _ran(before) == {"rows_x_stream"}
    ref = cg.rows_x_stream_plain(*tp, eps, with_phi=phi, dtype=torch.float64,
                                 **g)
    ref = ref if phi else (ref,)
    assert _rel(got[0], want[0]) < 5e-6
    gm64 = planes[4].astype(np.float64)
    oracle = jgrav.accel_potential_rows(rows, src, gm64, eps, 1.0, 64)
    assert _rel(ref[0], oracle[0]) < 1e-7
    assert _rel(got[0], oracle[0]) < 5e-6
    if phi:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=3e-5)
        # no row is a source at eps > 0 (and the guard drops the self pair
        # at eps = 0), so the raw potential is the oracle's
        np.testing.assert_allclose(ref[1].numpy(), np.asarray(oracle[1]),
                                   rtol=1e-7)


# --------------------------------------------------------------------------
# the dispatch grid
# --------------------------------------------------------------------------

class _Reached(Exception):
    pass


# the Pallas kernel functions -> the port's launch-counter keys
_JAX_KERNEL = {"_accel_kernel": "rows", "_accel_phi_kernel": "rows",
               "_accel_kernel_t": "rows_t", "_accel_phi_kernel_t": "rows_t",
               "_accel_stream_kernel": "rows_stream",
               "_accel_phi_stream_kernel": "rows_stream",
               "_accel_kernel_x": "rows_x", "_accel_phi_kernel_x": "rows_x",
               "_accel_stream_kernel_x": "rows_x_stream",
               "_accel_phi_stream_kernel_x": "rows_x_stream"}


def test_rows_dispatch_matches_the_jax_package(monkeypatch):
    """On a grid of (rows, sources) around the lowered thresholds, the
    port's four rows accel forms call the twin of the kernel that the JAX
    package's forms hand to ``pallas_call`` (caught before it runs)."""
    for mod in (pg, cg):
        monkeypatch.setattr(mod, "STREAM_N", 256)
        monkeypatch.setattr(mod, "RT_MIN_ACCEL", 128)
        monkeypatch.setattr(mod, "RT_MAX_ROWS", 64)

    def spy(kernel, *args, **kw):
        raise _Reached(kernel.func.__name__)

    monkeypatch.setattr(pg, "_call", spy)
    seen = set()
    for nr in (1, 63, 64, 65, 300):
        for ns in (100, 127, 128, 200, 256, 257, 400):
            rows, src, mass = _rows_case(nr, ns, 0.05, nr + ns)
            planes, _, _ = _planes(nr, ns, 0.05, nr * ns)
            tp = _t(*planes)
            calls = (
                (lambda: cg.accel_rows(*_t(rows, src, mass), EPS),
                 lambda: pg.accel_rows(rows, src, mass, EPS)),
                (lambda: cg.accel_potential_rows(*_t(rows, src, mass), EPS),
                 lambda: pg.accel_potential_rows(rows, src, mass, EPS)),
                (lambda: cg.accel_rows_x_hilo(*tp, EPS),
                 lambda: pg.accel_rows_x_hilo(*planes, EPS)),
                (lambda: cg.accel_potential_rows_x_hilo(*tp, EPS),
                 lambda: pg.accel_potential_rows_x_hilo(*planes, EPS)))
            for port, jax_form in calls:
                for fn in _PALLAS:
                    fn.clear_cache()
                before = dict(cg.PLAIN_CALLS)
                port()
                (key,) = _ran(before)
                with pytest.raises(_Reached) as hit:
                    jax_form()
                assert _JAX_KERNEL[str(hit.value)] == key, (nr, ns)
                assert cg.rows_route(nr, ns, extended="x" in key) == key
                seen.add(key)
    assert seen == {"rows", "rows_t", "rows_stream", "rows_x",
                    "rows_x_stream"}


# --------------------------------------------------------------------------
# the pruned ForceModel
# --------------------------------------------------------------------------

def _oracle(pos, vel, mass, mask):
    """f64 direct sums of the reduced system (cluster rows x all sources,
    tail rows x cluster sources; self pairs excluded): accel, phi, E_tot,
    and the accel + jerk."""
    p, v, m = pos, vel, mass.astype(np.float64)
    d = p[None, :, :] - p[:, None, :]
    dv = v[None, :, :] - v[:, None, :]
    r2 = (d ** 2).sum(-1) + EPS * EPS
    invr = 1.0 / np.sqrt(r2)
    np.fill_diagonal(invr, 0.0)
    inv3 = invr ** 3
    rv = (d * dv).sum(-1)

    def from_(msrc):
        w = msrc[None, :] * inv3
        acc = (w[:, :, None] * d).sum(1)
        jerk = (w[:, :, None] * (dv - 3.0 * (rv * invr ** 2)[:, :, None]
                                 * d)).sum(1)
        return acc, jerk, -(msrc[None, :] * invr).sum(1)

    full, cl = from_(m), from_(m * mask)
    sel = mask[:, None]
    acc = np.where(sel, full[0], cl[0])
    jerk = np.where(sel, full[1], cl[1])
    phi = np.where(mask, full[2], cl[2])
    pe = -np.outer(m, m) * invr
    ke = 0.5 * (m * (v ** 2).sum(1)).sum()
    e_tot = ke + 0.5 * (pe * ~np.outer(~mask, ~mask)).sum()
    return acc, jerk, phi, e_tot


@pytest.fixture(scope="module")
def pruned_setup():
    pos, vel, mass, ids = numpy_plummer(N, 17)
    r = np.linalg.norm(pos, axis=1)
    mask = r <= np.quantile(r, 0.2)          # the inner 20%: the cluster
    idx, wgt, n_c = jescape.build_sources(mask, 16)
    js = j_make_state(pos, vel, mass, ids)
    ts = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    return pos, vel, mass, mask, (idx, wgt, mask.astype(np.float64)), js, ts


def _pair(precision, src):
    jf = j_make_force_model(EPS, backend="jnp", precision=precision)
    tf = t_make_force_model(EPS, precision=precision)
    return (jf.with_sources(*(jnp.asarray(a) for a in src)),
            tf.with_sources(*(torch.from_numpy(a) for a in src)))


# oracle bounds of the JAX test: (accel, jerk, E_tot) per tier
_ORACLE_TOL = {"f32": (2e-6, 5e-6, 1e-6), "extended": (3e-7, 1e-6, 4e-7)}


@pytest.mark.parametrize("precision", ["f32", "extended"])
def test_pruned_force_model_matches_jax_and_the_oracle(pruned_setup,
                                                       precision):
    pos, vel, mass, mask, src, js, ts = pruned_setup
    jf, tf = _pair(precision, src)
    assert tf.pruned and tf.src_idx.dtype == torch.int64
    acc_o, jerk_o, phi_o, e_o = _oracle(pos, vel, mass, mask)
    tol_a, tol_j, tol_e = _ORACLE_TOL[precision]

    acc = tf.accel(ts.pos, ts.mass)
    assert acc.dtype == torch.float64
    assert _rel(acc, jf.accel(js.pos, js.mass)) < 5e-6
    assert _rel(acc, acc_o) < tol_a

    acc2, phi, phi_ext = tf.accel_potential(ts.pos, ts.mass)
    jacc2, jphi, _ = jf.accel_potential(js.pos, js.mass)
    assert _rel(acc2, acc) < 1e-6 and not bool(phi_ext.any())
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=3e-5)
    assert _rel(phi, phi_o, vector=False) < tol_a
    # the uniform 1/2 weight of the energies sums the mixed phi to the
    # reduced pair energy PE_CC + PE_CT
    e = float(tdiag.energies(ts, tf)["E_tot"])
    e_j = float(jdiag.energies(js, jf)["E_tot"])
    assert abs(e - e_o) / abs(e_o) < tol_e
    assert abs(e - e_j) / abs(e_o) < tol_e
    e_full = float(tdiag.energies(ts, tf.unpruned())["E_tot"])
    assert abs(e_full - e_o) / abs(e_o) > 1e-3     # tail-tail dropped

    a, j = tf.accel_jerk(ts.pos, ts.vel, ts.mass)
    ja, jj = jf.accel_jerk(js.pos, js.vel, js.mass)
    assert _rel(a, ja) < 5e-6 and _rel(j, jj) < 1e-5
    assert _rel(a, acc_o) < tol_a and _rel(j, jerk_o) < tol_j


@pytest.mark.parametrize("precision", ["f32", "extended"])
@pytest.mark.parametrize("rows", ["cluster", "tail", "mixed", "fill"])
def test_pruned_accel_jerk_on_rows(pruned_setup, precision, rows):
    """The block stepper's active-row form with the rows' membership: all
    cluster rows (rows x N), all tail rows (rows x B), mixed rows (both),
    and mixed rows with 0.5 "don't care" fill rows; the JAX package's jnp
    backend (its extended rows in f64) beside the port's twins."""
    pos, vel, mass, mask, src, js, ts = pruned_setup
    jf, tf = _pair(precision, src)
    members, tails = np.nonzero(mask)[0], np.nonzero(~mask)[0]
    pick = {"cluster": members[:40], "tail": tails[:40],
            "mixed": np.sort(np.r_[members[:20], tails[:20]]),
            "fill": np.sort(np.r_[members[:20], tails[:20]])}[rows]
    rmask = mask[pick].astype(np.float64)
    if rows == "fill":
        rmask[::4] = 0.5                 # don't-care rows (results unused)
    acc_o, jerk_o, _, _ = _oracle(pos, vel, mass, mask)
    got = tf.accel_jerk_on_rows(ts.pos[pick], ts.vel[pick], ts.pos, ts.vel,
                                ts.mass, rows_mask=torch.from_numpy(rmask))
    want = jf.accel_jerk_on_rows(js.pos[pick], js.vel[pick], js.pos, js.vel,
                                 js.mass, rows_mask=jnp.asarray(rmask))
    keep = rmask != 0.5
    for g, w, o, tol in ((got[0], want[0], acc_o, 5e-6),
                         (got[1], want[1], jerk_o, 1e-5)):
        g, w = g.numpy()[keep], np.asarray(w)[keep]
        assert g.dtype == np.float64
        assert _rel(g, w) < tol
        assert _rel(g, o[pick][keep]) < tol
    with pytest.raises(ValueError, match="rows_mask"):
        tf.accel_jerk_on_rows(ts.pos[pick], ts.vel[pick], ts.pos, ts.vel,
                              ts.mass)


def test_pruning_refusals():
    tf = t_make_force_model(EPS, precision="df32")
    with pytest.raises(ValueError, match="df32"):
        tf.with_sources(torch.zeros(4, dtype=torch.int64), torch.ones(4),
                        torch.ones(8))
    cfg = tconfig.load_config(f"{REPO}/configs/escape_prune_65k.toml")
    cfg = tconfig.apply_overrides(cfg, ["ic.n=256"])
    bad = (
        (dataclasses.replace(cfg, potential=dataclasses.replace(
            cfg.potential, kind="none"), orbit=dataclasses.replace(
            cfg.orbit, kind="none")), "external"),
        (dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, diag_f64=True)), "diag_f64"),
        (dataclasses.replace(cfg, integrator=dataclasses.replace(
            cfg.integrator, precision="df32")), "df32"))
    for c, match in bad:
        with pytest.raises(ValueError, match=match):
            trun.run(c, device="cpu")
    # the JAX package refuses the same three
    jcfg = jconfig.apply_overrides(jconfig.load_config(
        f"{REPO}/configs/escape_prune_65k.toml"), ["ic.n=256"])
    jf = j_make_force_model(EPS, backend="jnp", precision="df32")
    with pytest.raises(ValueError, match="df32"):
        jf.with_sources(jnp.zeros(4, jnp.int32), jnp.ones(4), jnp.ones(8))
    assert jcfg.escape.prune and cfg.escape.prune
