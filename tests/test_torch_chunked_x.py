"""The extended (hi/lo) tier past one resident set: the port's chunked
pair-symmetric self-interaction at the extended tier and its compensated
streamed active-row sum against the JAX package on identical inputs, on the
CPU at small size.

The cross-pair twins (K15 ``cross_x_plain``, K16 ``cross_jerk_x_plain``)
are held, through the public ``*_cross_pair_x_hilo`` wrappers, to
``oc_nbody_tpu/ops/df32.py``'s cross-pair twins and to the Pallas cross
kernel #20 with ``_OP_AX``, ``_OP_PX`` and ``_OP_JX`` run in interpret mode
through ``pallas_gravity.*_cross_pair_x_hilo``, with the extended sym tiles
at 64. The chunked forms (``accel_sym_x_chunked``,
``accel_potential_sym_x_chunked``, ``accel_jerk_sym_x_chunked``) are held
to the JAX package's at chunk = 128: n = 300 gives three chunks with a
ragged last one (the port keeps it ragged, JAX pads it with zero-mass
particles), n = 100 one chunk. ``accel_jerk_rows_x_hilo`` past STREAM_N
sources or past RT_MAX_ROWS rows (K17's twin) is held to the JAX package's
own dispatch there, #15 ``_accel_jerk_stream_kernel_x`` in interpret mode
with its tiles lowered so that its Kahan steps run across several source
tiles. Then a few KDK steps of c6 at the extended tier through the chunked
route against the JAX package's steps from the same IC, and c4 at the
extended tier past a lowered RT_MAX_ROWS through the CLI: its all-active
micro-steps take K17's twin and the run reaches its end.

Tolerances are the JAX package's own (test_pallas_tiers.py:51,96,108 and
tests/test_torch_extended.py): between the port and JAX 5e-6·max|a|,
1e-5·max|j| and 5e-6·max|phi|; against the f64 oracle 2e-5·max|a| and
5e-5·max|j|; the f64 evaluation of the same planes matches the f64 oracle
to 1e-7 (the one f32 rounding the planes hold, gm = fl32(G m)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_gravity as pg
from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.ops import df32 as jdf32
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from test_torch_orbit import C4
from test_torch_slice import REPO, numpy_plummer

G = 1.3
CHUNK = 128
C6 = f"{REPO}/configs/c6_1m_streamed.toml"
_PALLAS = (pg.accel_cross_pair_x_hilo, pg.accel_potential_cross_pair_x_hilo,
           pg.accel_jerk_cross_pair_x_hilo, pg.accel_sym_x_chunked,
           pg.accel_potential_sym_x_chunked, pg.accel_jerk_sym_x_chunked,
           pg.accel_jerk_rows_x_hilo)


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    for name in ("T_SYMX", "T_SYMXP", "T_SYMXJ"):
        monkeypatch.setattr(pg, name, 64)
    for fn in _PALLAS:
        fn.clear_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    for fn in _PALLAS:
        fn.clear_cache()


def _cluster(n, seed, offset=(0.0, 0.0, 0.0)):
    """(pos, vel, mass) f64: a smooth normal cluster, unequal masses."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) + np.asarray(offset)
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def _split_np(pos, vel, mass, center=None, vcenter=None):
    """numpy (hi, lo, vhi, vlo, gm) planes under one centring."""
    c = pos.mean(axis=0) if center is None else center
    vc = vel.mean(axis=0) if vcenter is None else vcenter
    out = []
    for x in (pos - c, vel - vc):
        hi = x.astype(np.float32)
        out += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    return (*out, (G * mass).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _rel(got, want, vector=True):
    """max row error over max row size (norms for vectors)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vector:
        return (np.linalg.norm(got - want, axis=1).max()
                / np.linalg.norm(want, axis=1).max())
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("op", ["A", "P", "J"])
def test_cross_x_twins_match_jax_and_pallas(op, eps):
    """The three extended cross-pair forms on ragged disjoint sets (150 x
    90) split under ONE centring, 8 kpc out: the port's public wrappers
    (K15/K16's f32 twins on the CPU) against the Pallas cross kernel in
    interpret mode and JAX's jnp twins; the f64 twins against the f64
    oracle; the potential holds no self term."""
    nA = 150
    pos, vel, mass = _cluster(240, 31, offset=(8000.0, 0.0, -3.0))
    hi, lo, vhi, vlo, gm = _split_np(pos, vel, mass)
    A, B = slice(0, nA), slice(nA, None)
    guarded = eps == 0.0
    if op == "J":
        planes = (hi[A], lo[A], vhi[A], vlo[A], hi[B], lo[B], vhi[B], vlo[B],
                  gm[A], gm[B])
        fn, jfn, jtier, key = (cg.accel_jerk_cross_pair_x_hilo,
                               pg.accel_jerk_cross_pair_x_hilo,
                               jdf32.accel_jerk_cross_pair_x_hilo,
                               "cross_jerk_x")
        ref = jgrav.accel_jerk_cross_pair(pos[A], vel[A], pos[B], vel[B],
                                          mass[A], mass[B], eps, G)
        tols = (5e-6, 1e-5, 5e-6, 1e-5)
    else:
        planes = (hi[A], lo[A], hi[B], lo[B], gm[A], gm[B])
        fn, jfn, jtier = (
            (cg.accel_potential_cross_pair_x_hilo,
             pg.accel_potential_cross_pair_x_hilo,
             jdf32.accel_potential_cross_pair_x_hilo) if op == "P"
            else (cg.accel_cross_pair_x_hilo, pg.accel_cross_pair_x_hilo,
                  jdf32.accel_cross_pair_x_hilo))
        key = "cross_x"
        jref = (jgrav.accel_potential_cross_pair if op == "P"
                else jgrav.accel_cross_pair)
        ref = jref(pos[A], pos[B], mass[A], mass[B], eps, G)
        tols = (5e-6, 5e-6, 5e-6, 5e-6)
    vector = [op != "P" or k % 2 == 0 for k in range(len(ref))]
    plain = dict(cg.PLAIN_CALLS)
    got = fn(*_t(*planes), eps, guarded=guarded)
    assert cg.PLAIN_CALLS[key] == plain[key] + 1
    assert all(g.dtype == torch.float32 for g in got)
    assert [tuple(g.shape) for g in got] == [np.shape(r) for r in ref]
    jplanes = tuple(map(jnp.asarray, planes))
    for other in (jfn(*jplanes, eps, guarded=guarded),
                  jtier(*jplanes, eps, chunk=64, guarded=guarded)):
        for g, o, tol, vec in zip(got, other, tols, vector):
            assert _rel(g, o, vec) < tol
    twin = cg.cross_jerk_x_plain if op == "J" else cg.cross_x_plain
    kw = {} if op == "J" else dict(with_phi=op == "P")
    f64 = twin(*_t(*planes), eps, dtype=torch.float64, chunk=64,
               guarded=guarded, **kw)
    for g, o, f, vec in zip(got, ref, f64, vector):
        assert f.dtype == torch.float64
        assert _rel(f, o, vec) < 1e-7
        assert _rel(g, o, vec) < (2e-5 if vec else 5e-6)


@pytest.mark.parametrize("n,eps", [(300, 0.0), (300, 0.05), (100, 0.05)])
def test_chunked_x_forms_match_jax(n, eps):
    """accel_sym_x_chunked, accel_potential_sym_x_chunked and
    accel_jerk_sym_x_chunked at chunk = 128 (n = 300: chunks of 128, 128
    and 44; n = 100: one chunk) against the JAX package's at the same chunk
    in interpret mode, eps > 0 unguarded and eps = 0 guarded, and against
    the f64 oracle (the raw potential plus self_phi); the route is K6's/K7's
    twin on each diagonal chunk and K15's/K16's on each chunk pair, the one
    centring and split of the whole set, and no launch is counted."""
    pos, vel, mass = _cluster(n, n + 5, offset=(0.0, 8000.0, 1.0))
    guarded = eps == 0.0
    tp, tv, tm = _t(pos, vel, mass)
    c = -(-n // CHUNK)
    launches, plain = dict(cg.LAUNCHES), dict(cg.PLAIN_CALLS)
    kw = dict(guarded=guarded, chunk=CHUNK)
    acc = cg.accel_sym_x_chunked(tp, tm, eps, G, **kw)
    acc_p, phi = cg.accel_potential_sym_x_chunked(tp, tm, eps, G, **kw)
    acc_j, jerk = cg.accel_jerk_sym_x_chunked(tp, tv, tm, eps, G, **kw)
    assert cg.LAUNCHES == launches
    assert cg.PLAIN_CALLS["sym_x"] == plain["sym_x"] + 2 * c
    assert cg.PLAIN_CALLS["cross_x"] == plain["cross_x"] + c * (c - 1)
    assert cg.PLAIN_CALLS["sym_jerk_x"] == plain["sym_jerk_x"] + c
    assert cg.PLAIN_CALLS["cross_jerk_x"] == \
        plain["cross_jerk_x"] + c * (c - 1) // 2
    assert acc.dtype == phi.dtype == jerk.dtype == torch.float64
    jp, jv, jm = map(jnp.asarray, (pos, vel, mass))
    ref_a = pg.accel_sym_x_chunked(jp, jm, eps, G, **kw)
    ref_ap, ref_phi = pg.accel_potential_sym_x_chunked(jp, jm, eps, G, **kw)
    ref_aj, ref_j = pg.accel_jerk_sym_x_chunked(jp, jv, jm, eps, G, **kw)
    for got, want in ((acc, ref_a), (acc_p, ref_ap), (acc_j, ref_aj)):
        assert _rel(got, want) < 5e-6
    assert _rel(phi, ref_phi, vector=False) < 5e-6
    assert _rel(jerk, ref_j) < 1e-5
    o_a, o_phi = jgrav.accel_potential_direct(jp, jm, eps, G)
    _, o_j = jgrav.accel_jerk_direct(jp, jv, jm, eps, G)
    for got in (acc, acc_p, acc_j):
        assert _rel(got, o_a) < 2e-5
    assert _rel(jerk, o_j) < 5e-5
    phi = phi.numpy() + G * mass / eps if eps > 0 else phi.numpy()
    assert _rel(phi, o_phi, vector=False) < 5e-6


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("cap,nr", [("sources", 1), ("sources", 300),
                                    ("rows", 100)])
def test_rows_x_past_the_caps_match_the_streamed_kernel(monkeypatch, cap, nr,
                                                        eps):
    """accel_jerk_rows_x_hilo past STREAM_N sources (lowered to 256, 300
    sources) or past RT_MAX_ROWS rows (lowered to 16: 100 rows of 200
    sources) routes
    to K17's twin, as the JAX package routes both to #15 (interpret mode,
    tiles of 64 rows by 128 sources so that its Kahan steps run across
    source tiles); against it, the jnp tier and the f64 rows oracle."""
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(pg, "STREAM_N", 256)
    if cap == "rows":
        monkeypatch.setattr(cg, "RT_MAX_ROWS", 16)
        monkeypatch.setattr(pg, "RT_MAX_ROWS", 16)
    monkeypatch.setattr(pg, "TI_XS", 64)
    monkeypatch.setattr(pg, "TJ_XS", 128)
    ns = 300 if cap == "sources" else 200
    pos, vel, mass = _cluster(ns, 61 + nr, offset=(-8000.0, 0.0, 0.0))
    rows = np.random.default_rng(62).choice(ns, nr, replace=False) \
        if nr < ns else np.arange(ns)
    rpos, rvel = pos[rows] + 1e-3, vel[rows] - 1e-3
    shi, slo, svhi, svlo, gm = _split_np(pos, vel, mass)
    rhi, rlo, vhi, vlo, _ = _split_np(rpos, rvel, mass[rows],
                                      pos.mean(axis=0), vel.mean(axis=0))
    planes = (rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm)
    guarded = eps == 0.0
    plain = dict(cg.PLAIN_CALLS)
    got = cg.accel_jerk_rows_x_hilo(*_t(*planes), eps, guarded=guarded)
    assert cg.PLAIN_CALLS["rows_jerk_x_stream"] == \
        plain["rows_jerk_x_stream"] + 1
    assert cg.PLAIN_CALLS["rows_jerk_x"] == plain["rows_jerk_x"]
    assert tuple(got[0].shape) == tuple(got[1].shape) == (nr, 3)
    jplanes = tuple(map(jnp.asarray, planes))
    for other in (pg.accel_jerk_rows_x_hilo(*jplanes, eps, guarded=guarded),
                  jdf32.accel_jerk_rows_x_hilo(*jplanes, eps, chunk=64,
                                               guarded=guarded)):
        assert _rel(got[0], other[0]) < 5e-6
        assert _rel(got[1], other[1]) < 1e-5
    a_ref, j_ref = jgrav.accel_jerk_rows(rpos, rvel, pos, vel, mass, eps, G,
                                         128)
    assert _rel(got[0], a_ref) < 2e-5 and _rel(got[1], j_ref) < 5e-5


def test_c6_extended_kdk_steps_through_the_chunked_route_match_jax(
        monkeypatch):
    """c6 at the extended tier (Plummer on the circular 8 kpc orbit, KDK at
    dt = 1/256) at n = 300 with STREAM_N lowered to 256 and chunk 128:
    eight steps through the port's chunked route (K6's and K15's twins on
    planes split once per evaluation) against the JAX package's extended
    steps (its jnp tier) from the same IC. Positions agree to 1e-9 of the
    cluster's size: both forces are the extended tier's, f32 sums of the
    same pair terms in different orders."""
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(cg, "CHUNK_SYMX", CHUNK)
    n, steps = 300, 8
    over = [f"ic.n={n}", "integrator.precision=extended"]
    cfg_j = jconfig.apply_overrides(jconfig.load_config(C6), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(C6), over)
    pos, vel, mass, ids = numpy_plummer(n, seed=6)
    us = jscene.build_units(cfg_j)
    ext = jscene.build_external_potential(cfg_j, us)
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext,
                                  cfg_j, us)
    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=ext, backend="jnp",
                               precision="extended")
    stepper, kind = jscene.make_stepper(cfg_j, force)
    carry = jax.jit(stepper.advance, static_argnums=1)(stepper.init(state),
                                                       steps)
    tus = tscene.build_units(cfg_t)
    text = tscene.build_external_potential(cfg_t, tus)
    tstate = tscene.place_on_orbit(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), text, cfg_t, tus)
    tforce = t_make_force_model(cfg_t.integrator.eps, tus.G, text,
                                precision="extended")
    tstepper, tkind = tscene.make_stepper(cfg_t, tforce)
    assert kind == tkind == "kdk"
    plain = dict(cg.PLAIN_CALLS)
    tcarry = tstepper.advance(tstepper.init(tstate), steps)
    assert cg.PLAIN_CALLS["sym_x"] == plain["sym_x"] + 3 * (steps + 1)
    assert cg.PLAIN_CALLS["cross_x"] == plain["cross_x"] + 3 * (steps + 1)
    assert {k for k in plain if cg.PLAIN_CALLS[k] != plain[k]} == \
        {"sym_x", "cross_x"}
    size = float(np.abs(pos - pos.mean(axis=0)).max())
    np.testing.assert_allclose(tcarry.state.pos.numpy(),
                               np.asarray(carry.state.pos), rtol=0,
                               atol=1e-9 * size)
    assert tcarry.state.time == pytest.approx(float(carry.state.time),
                                              rel=1e-15)


def test_c4_extended_past_the_row_cap_runs_to_its_end(monkeypatch, capsys):
    """c4 at the extended tier (block steps, dt_max = 1/64) at n = 256 with
    RT_MAX_ROWS lowered to 200 and SYM_MIN to 128 (so that, as at N =
    131,072 on the card, the self-interaction and the diagnostics potential
    are pair-symmetric and only the active rows meet the row cap), through
    the CLI on the CPU to t = 2 dt_max: every particle is active at t = 1/64
    and 1/32, so those micro-steps take K17's twin and the others K9's; the
    run reaches its end inside c4's drift bound and ``info`` names the
    route."""
    monkeypatch.setattr(cg, "RT_MAX_ROWS", 200)
    monkeypatch.setattr(cg, "SYM_MIN", 128)
    over = ["ic.n=256", "integrator.precision=extended",
            "output.t_end=0.03125", "output.diag_every=0.015625",
            "output.snap_every=0.015625"]
    argv = [x for o in over for x in ("--set", o)]
    plain = dict(cg.PLAIN_CALLS)
    assert tmain.main(["run", C4, "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: t=0.03125 ")
    fields = dict(f.split("=", 1) for f in done[0].split() if "=" in f)
    steps = int(fields["steps"])
    assert float(fields["max|dE/E_int|"]) < 2e-5
    ran = {k: cg.PLAIN_CALLS[k] - plain[k] for k in plain
           if cg.PLAIN_CALLS[k] != plain[k]}
    assert set(ran) == {"sym_jerk_x", "sym_x", "rows_jerk_x",
                        "rows_jerk_x_stream", "knn_density"}
    assert ran["sym_jerk_x"] == 1 and ran["sym_x"] == 3    # init; 3 rows
    assert ran["knn_density"] == 3                        # CH85 per row
    assert ran["rows_jerk_x_stream"] >= 2
    assert ran["rows_jerk_x_stream"] + ran["rows_jerk_x"] == steps
    assert tmain.main(["info", C4, *argv]) == 0
    assert ("N = 256: accel + jerk: K7 (pair-symmetric, resident); "
            "potential: K6 (pair-symmetric, resident); active rows: K9, K17 "
            "(compensated) past RT_MAX_ROWS rows" in capsys.readouterr().out)
