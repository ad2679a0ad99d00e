"""The ported paths as a whole, against the JAX package.

One numpy IC goes through both packages on each scene: c1 (Plummer,
isolated, N=256), the north star (Plummer on a circular 8 kpc orbit in the
Milky Way, N overridden to 512), c2 (the JAX package's King sample on the
same orbit, N=512) and c3 (Plummer with Kroupa masses, isolated, N=512):
place_on_orbit -> the config's stepper (KDK: 64 steps; Hermite:
advance_to(1/32)) -> compute_all. The two differ only by f32
pair-summation order, so positions agree to 1e-9 of the cluster size
(measured: ~5e-11 under KDK) and every diagnostics column to 1e-6 relative
(measured: <= 6e-8; N_bound within ±1, and the components of L to 1e-9 of
|L|). Under Hermite both land on the same time in as many steps. Also: the
CLI on c1, c2 and c3, the refusals of what is not ported, and that the port
imports no JAX.

The extended (hi/lo) precision tier as a whole: a KDK (c5x's scene), a
Hermite (c3) and a block (c4) run with ``precision = "extended"`` from the
same numpy state through the JAX package's ``ForceModel(backend="pallas",
precision="extended")``, its Pallas kernels in interpret mode, and through
the port on the CPU (the plain twins of K6-K9): positions to 1e-9 of the
cluster size, the diagnostics columns as above; the ``diag_f64`` row equal
to JAX's to 1e-12 relative; N past ``STREAM_N`` and more than one
device refused with their ROADMAP items.
"""
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import diagnostics as jdiag
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK as JLeapfrogKDK
from oc_nbody_tpu.models.king import king as j_king
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import diagnostics as tdiag
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.interop import state_from_numpy, state_to_numpy
from oc_nbody_tpu_torch.models import imf as timf
from oc_nbody_tpu_torch.ops import gravity as tgravity
from oc_nbody_tpu_torch.run import _to_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C1 = os.path.join(REPO, "configs", "c1_plummer_1k.toml")
C2 = os.path.join(REPO, "configs", "c2_king_8k_circular.toml")
C3 = os.path.join(REPO, "configs", "c3_hermite_16k_kroupa.toml")
NORTH_STAR = os.path.join(REPO, "configs", "north_star_65k_orbit.toml")
C4 = os.path.join(REPO, "configs", "c4_block_32k_eccentric.toml")
C5X = os.path.join(REPO, "configs", "c5x_131k_extended.toml")
N_STEPS = 64
T_HERMITE = 1.0 / 32


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def numpy_plummer(n, seed, a=3.0 * math.pi / 16.0):
    """Hénon-unit Plummer sphere (Aarseth–Hénon–Wielen) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def isotropic():
        z = rng.uniform(-1.0, 1.0, n)
        ph = rng.uniform(0.0, 2.0 * np.pi, n)
        s = np.sqrt(1.0 - z * z)
        return np.stack([s * np.cos(ph), s * np.sin(ph), z], axis=1)

    r = a / np.sqrt(rng.uniform(0.0, 0.999, n) ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * isotropic()
    q = np.empty(n)
    todo = np.ones(n, bool)
    while todo.any():
        qc = rng.uniform(0.0, 1.0, n)
        ok = todo & (rng.uniform(0.0, 0.0935, n)
                     < qc * qc * (1.0 - qc * qc) ** 3.5)
        q[ok] = qc[ok]
        todo &= ~ok
    vel = (q * np.sqrt(2.0) * (r * r + a * a) ** -0.25)[:, None] * isotropic()
    mass = np.full(n, 1.0 / n, np.float32)
    pos -= pos.mean(axis=0)
    vel -= vel.mean(axis=0)
    return pos, vel, mass, np.arange(n, dtype=np.int32)


def numpy_kroupa(n, seed):
    """Kroupa masses in [0.08, 100] Msun from numpy uniforms, total 1, f32."""
    u = np.random.default_rng(seed).uniform(size=n)
    m = timf.inverse_cdf(torch.from_numpy(u),
                         *timf.kroupa_segments(0.08, 100.0)).numpy()
    return (m / m.sum()).astype(np.float32)


def _numpy_ic(cfg, n, seed):
    """The scene's IC as numpy arrays for both packages: the JAX package's
    King sample for a King config, else numpy_plummer, with Kroupa masses
    where the config asks for them."""
    if cfg.ic.kind == "king":
        s = j_king(n, cfg.ic.w0, seed=seed)
        return (np.asarray(s.pos), np.asarray(s.vel), np.asarray(s.mass),
                np.arange(n, dtype=np.int32))
    pos, vel, mass, ids = numpy_plummer(n, seed)
    if cfg.ic.imf == "kroupa":
        mass = numpy_kroupa(n, seed + 1)
    return pos, vel, mass, ids


def _both(path, n, seed, precision=None):
    """(JAX row, port row, JAX final pos, port final pos, cluster size, the
    softened self-potential energy scale G·Σm²/eps). ``precision``
    overrides the config's tier; the JAX side then runs its Pallas backend
    (in interpret mode: the caller sets OCN_PALLAS_INTERPRET)."""
    over = [f"ic.n={n}"]
    if precision:
        over.append(f"integrator.precision={precision}")
    cfg_j = jconfig.apply_overrides(jconfig.load_config(path), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(path), over)
    pos, vel, mass, ids = _numpy_ic(cfg_j, n, seed)
    fr = cfg_j.output.fractions

    us = jscene.build_units(cfg_j)
    ext = jscene.build_external_potential(cfg_j, us)
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext,
                                  cfg_j, us)
    tier = cfg_j.integrator.precision
    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=ext, precision=tier,
                               backend="jnp" if tier == "f32" else "pallas")
    stepper, kind = jscene.make_stepper(cfg_j, force)
    if kind == "kdk":
        carry = jax.jit(stepper.advance, static_argnums=1)(
            stepper.init(state), N_STEPS)
    else:
        carry = jax.jit(stepper.advance_to)(stepper.init(state), T_HERMITE)
    row_j = jax.device_get(jax.jit(
        lambda s: jdiag.compute_all(s, force, fr))(carry.state))
    pos_j = np.asarray(carry.state.pos)

    tus = tscene.build_units(cfg_t)
    text = tscene.build_external_potential(cfg_t, tus)
    tstate = tscene.place_on_orbit(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), text, cfg_t, tus)
    tforce = t_make_force_model(cfg_t.integrator.eps, tus.G, text,
                                precision=cfg_t.integrator.precision)
    tstepper, tkind = tscene.make_stepper(cfg_t, tforce)
    assert tkind == kind and tforce.precision == tier
    if kind == "kdk":
        tcarry = tstepper.advance(tstepper.init(tstate), N_STEPS)
    else:
        tcarry = tstepper.advance_to(tstepper.init(tstate), T_HERMITE)
    assert tcarry.n_steps == int(carry.n_steps)
    assert tcarry.state.time == float(carry.state.time)
    row_t = _to_host(tdiag.compute_all(tcarry.state, tforce, fr))
    size = float(np.abs(pos - pos.mean(axis=0)).max())
    m64 = mass.astype(np.float64)
    self_scale = us.G * float(np.sum(m64 * m64)) / cfg_j.integrator.eps
    return row_j, row_t, pos_j, tcarry.state.pos.numpy(), size, self_scale


@pytest.mark.parametrize("path,n", [(C1, 256), (NORTH_STAR, 512), (C2, 512),
                                    (C3, 512)],
                         ids=["c1", "north_star", "c2", "c3"])
def test_slice_matches_jax(path, n):
    _check_slice(path, n, *_both(path, n, seed=n))


@pytest.mark.parametrize("path,n", [(C5X, 384), (C3, 256), (C4, 256)],
                         ids=["c5x-kdk", "c3x-hermite", "c4x-block"])
def test_extended_slice_matches_jax(path, n, monkeypatch):
    """The extended tier end to end: JAX through its Pallas kernels
    (interpret mode), the port through the twins of K6-K9 on the CPU."""
    import oc_nbody_tpu.ops.pallas_gravity as pg
    jitted = (pg.accel_x, pg.accel_potential_x, pg.accel_jerk_rows_x,
              pg.accel_rows_x_hilo, pg.accel_potential_rows_x_hilo,
              pg.accel_jerk_rows_x_hilo)
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    for fn in jitted:
        fn.clear_cache()
    try:
        out = _both(path, n, seed=n + 1, precision="extended")
    finally:
        for fn in jitted:
            fn.clear_cache()
    _check_slice(path, n, *out)


def _check_slice(path, n, row_j, row_t, pos_j, pos_t, size, self_scale):
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-9 * size)
    # c3's Kroupa masses: each f32 phi holds the softened self term
    # -G m_i/eps until self_phi removes it, so the potential-energy columns
    # carry its f32 rounding, a few 2^-24 of G·Σm²/eps (6.6 here; measured
    # 1.25 ulps of it); with equal masses it is below the 1e-6 rtol
    e_atol = 2.0 ** -22 * self_scale if path == C3 else 0.0
    e_cols = {"PE_pair": e_atol, "E_tot": e_atol, "E_int": e_atol,
              "Q_virial": e_atol * float(row_j["Q_virial"])
              / abs(float(row_j["PE_pair"]))}
    assert set(row_t) == set(row_j)
    n_bound_moved = row_t["N_bound"] != float(row_j["N_bound"])
    assert abs(row_t["N_bound"] - float(row_j["N_bound"])) <= 1
    for k, v in row_t.items():
        ref = float(row_j[k])
        if k == "N_bound" or not np.isfinite(ref):
            assert np.isfinite(v) == np.isfinite(ref), k
            continue
        # bound-set columns move by one star's worth if N_bound does
        rtol = 2.0 / n if n_bound_moved and k in ("M_bound", "t_rh") \
            else 1e-6
        # the components of L on an orbit run are a cancellation of
        # galactic-scale terms: held to L_norm, not to themselves
        atol = 1e-9 * float(row_j["L_norm"]) if k in ("Lx", "Ly", "Lz") \
            else e_cols.get(k, 0.0)
        np.testing.assert_allclose(v, ref, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("path", [C5X, C1], ids=["orbit", "isolated"])
def test_diag_f64_row_matches_jax(path):
    """``output.diag_f64``: the pairwise potential of the row is the plain
    f64 sum in both packages (on the CPU; the port's card runs K23), shared
    by the energies and, for an isolated cluster, the bound-mass cut: 1e-12
    relative."""
    n = 300
    cfg_j = jconfig.apply_overrides(jconfig.load_config(path), [f"ic.n={n}"])
    cfg_t = tconfig.apply_overrides(tconfig.load_config(path), [f"ic.n={n}"])
    pos, vel, mass, ids = numpy_plummer(n, seed=31)
    us = jscene.build_units(cfg_j)
    ext = jscene.build_external_potential(cfg_j, us)
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext,
                                  cfg_j, us)
    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=ext, backend="jnp")
    fr = cfg_j.output.fractions
    row_j = jax.device_get(jax.jit(lambda s: jdiag.compute_all(
        s, force, fr, f64_pairwise=True))(state))
    tus = tscene.build_units(cfg_t)
    text = tscene.build_external_potential(cfg_t, tus)
    tstate = tscene.place_on_orbit(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), text, cfg_t, tus)
    tforce = t_make_force_model(cfg_t.integrator.eps, tus.G, text,
                                precision=cfg_t.integrator.precision)
    row_t = _to_host(tdiag.compute_all(tstate, tforce, fr,
                                       f64_pairwise=True))
    for k in ("KE", "PE_pair", "E_ext", "E_tot", "E_int", "M_bound",
              "N_bound", "Q_virial"):
        np.testing.assert_allclose(row_t[k], float(row_j[k]), rtol=1e-12,
                                   err_msg=k)
    # the f64 potential alone, against the f64 oracle and the accel form
    tp, tm = tstate.pos, tstate.mass
    phi = tgravity.potential(tp, tm, tforce.eps, tforce.G, chunk=64)
    _, phi_ref = tgravity.accel_potential_direct(tp, tm.double(), tforce.eps,
                                                 tforce.G)
    torch.testing.assert_close(phi, phi_ref, rtol=1e-12, atol=0)
    e = tdiag.energies(tstate, tforce, f64_pairwise=True)
    assert float(e["PE_pair"]) == pytest.approx(row_t["PE_pair"], rel=1e-14)


def test_state_round_trips_through_numpy():
    pos, vel, mass, ids = numpy_plummer(32, seed=1)
    state = state_from_numpy(pos, vel, mass, ids, 0.25, "cpu")
    assert state.pos.dtype == state.vel.dtype == torch.float64
    assert state.mass.dtype == torch.float32
    assert state.ids.dtype == torch.int32 and state.time == 0.25
    back = state_to_numpy(state)
    for got, want in zip(back, (pos, vel, mass, ids, 0.25)):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_cli_runs_c1_on_cpu(capsys):
    rc = tmain.main(["run", C1, "--device", "cpu", "--set", "ic.n=256",
                     "--set", "output.t_end=0.7071068"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("t=")]
    assert len(lines) == 1
    de = float(lines[0].split("dE/E=")[1].split()[0])
    assert abs(de) < 1e-5
    assert "steps=1449" in lines[0]


@pytest.mark.parametrize("path,n,t_end", [(C3, 256, 0.125), (C2, 256, 0.25)],
                         ids=["c3", "c2"])
def test_cli_runs_hermite_and_king_on_cpu(capsys, path, n, t_end):
    """c3 (adaptive steps: their count follows the f32 force rounding, ~140
    here) and c2 (fixed dt = 1/512: 128 steps) through the CLI."""
    rc = tmain.main(["run", path, "--device", "cpu", "--set", f"ic.n={n}",
                     "--set", f"output.t_end={t_end}"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("t=")]
    assert len(lines) == 1
    assert float(lines[0].split("t=")[1].split()[0]) == t_end
    de = float(lines[0].split("dE/E=")[1].split()[0])
    assert abs(de) < 1e-5
    steps = int(lines[0].split("steps=")[1].split()[0])
    assert (100 < steps < 200) if path == C3 else steps == 128


def test_cli_info_and_refusals(capsys):
    assert tmain.main(["info", C1, "--set", "ic.n=64"]) == 0
    out = capsys.readouterr().out
    assert '"n": 64' in out and "stepper: kdk LeapfrogKDK" in out
    assert tmain.main(["info", C3]) == 0
    assert "stepper: hermite Hermite4" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A3"):
        tmain.main(["run", C1, "--device", "cpu", "--resume"])
    with pytest.raises(NotImplementedError, match="A16"):
        tmain.main(["ensemble", C1, "--seeds", "0:2"])
    with pytest.raises(ValueError, match="JAX backend"):
        tmain.main(["run", C1, "--device", "cpu", "--set", "backend=jnp"])
    assert tmain.main(["info", os.path.join(REPO, "configs",
                                            "c4_block_32k_eccentric.toml")]) == 0
    assert "stepper: block BlockHermite" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A14"):
        tmain.main(["run", C1, "--device", "cpu", "--set",
                    "integrator.kind=yoshida4"])
    with pytest.raises(NotImplementedError, match="A11"):
        tmain.main(["run", C3, "--device", "cpu", "--set",
                    "integrator.pair_dt=true"])
    with pytest.raises(NotImplementedError, match="A18"):
        tmain.main(["run", C3, "--device", "cpu", "--set",
                    "integrator.macro_batches=4"])
    with pytest.raises(NotImplementedError, match="A14"):
        tmain.main(["run", C1, "--device", "cpu", "--set", "ic.kind=dehnen"])
    # the precision tiers: extended and df32 run; past the resident kernels
    # the extended tier goes chunked and the df32 tier is refused by name
    assert tmain.main(["info", C5X]) == 0
    out = capsys.readouterr().out
    assert "pairwise precision tier: extended; diagnostics potential: f64" \
        in out
    assert tmain.main(["info", C1]) == 0
    assert "precision tier: f32; diagnostics potential: the tier" \
        in capsys.readouterr().out
    assert tmain.main(["info", C1, "--set", "integrator.precision=df32"]) == 0
    assert "precision tier: df32; diagnostics potential: the tier" \
        in capsys.readouterr().out
    assert tmain.main(["run", C1, "--device", "cpu", "--set", "ic.n=64",
                       "--set", "integrator.precision=df32", "--set",
                       "output.t_end=0.0078125", "--set",
                       "output.diag_every=0.0078125"]) == 0
    assert "steps=16" in capsys.readouterr().out
    assert t_make_force_model(0.01, precision="df32").precision == "df32"
    with pytest.raises(ValueError, match="unknown precision"):
        t_make_force_model(0.01, precision="f16")
    assert tmain.main(["info", C5X, "--set", "ic.n=262145"]) == 0
    assert ("N = 262145: accel and potential: chunked pair-symmetric: K6 on "
            "3 diagonal chunks" in capsys.readouterr().out)
    with pytest.raises(NotImplementedError, match="B10"):
        tmain.main(["run", C5X, "--device", "cpu", "--set", "ic.n=262145",
                    "--set", "integrator.precision=df32"])
    with pytest.raises(ValueError, match="requested 4 devices, only 1 "
                                         "visible"):
        tmain.main(["run", C5X, "--device", "cpu", "--set",
                    "mesh.n_devices=4"])


def test_cli_runs_c5x_and_the_extended_overrides_on_cpu(capsys):
    """c5x as committed but for N and length (mesh.n_devices = 0 resolves to
    the one CPU; diag_f64 rows), and --set integrator.precision=extended on
    c1, through the twins of K6/K8 and nothing of the f32 tier."""
    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    for argv, steps in (
            (["run", C5X, "--device", "cpu", "--set", "ic.n=256", "--set",
              "output.t_end=0.0625", "--set", "output.diag_every=0.0625"],
             64),
            (["run", C1, "--device", "cpu", "--set", "ic.n=128", "--set",
              "integrator.precision=extended", "--set",
              "output.t_end=0.0625", "--set", "output.diag_every=0.0625"],
             128)):
        before = dict(cg.PLAIN_CALLS)
        assert tmain.main(argv) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("t=")]
        assert len(lines) == 1 and f"steps={steps}" in lines[0]
        assert abs(float(lines[0].split("dE/E=")[1].split()[0])) < 1e-6
        ran = {k for k in before if cg.PLAIN_CALLS[k] != before[k]}
        # c5x's rows are f64 sums through K23's twin; c1x's go through K8's;
        # each row's CH85 through K22's
        f64_rows = argv[1] == C5X
        assert ran == {"rows_x", "knn_density"} | (
            {"phi_f64"} if f64_rows else set())
        assert cg.PLAIN_CALLS["rows_x"] - before["rows_x"] == \
            steps + 1 + (0 if f64_rows else 2)
        assert cg.PLAIN_CALLS["knn_density"] - before["knn_density"] == 2
        assert cg.PLAIN_CALLS["phi_f64"] - before["phi_f64"] == \
            (2 if f64_rows else 0)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.resolve_device("cuda")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import oc_nbody_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'oc_nbody_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_leapfrog_counts_steps_on_the_host_like_jax():
    """advance_to takes whole steps until time >= t_end - 1e-12·|t_end|,
    on host floats: the same step count and the same f64 time as JAX."""
    cfg = tconfig.apply_overrides(tconfig.load_config(C1), ["ic.n=64"])
    scene = tscene.build_scene(cfg, "cpu")
    stepper, kind = tscene.make_stepper(cfg, scene.force)
    assert kind == "kdk"
    carry = stepper.init(scene.state)
    t_end = 0.01
    carry = stepper.advance_to(carry, t_end)
    assert stepper.reached(carry, t_end)
    assert not stepper.reached(carry, t_end + cfg.integrator.dt)
    jforce = j_make_force_model(eps=cfg.integrator.eps, G=1.0,
                                backend="jnp")
    jstepper = JLeapfrogKDK(force=jforce, dt=cfg.integrator.dt)
    pos, vel, mass, ids, _ = state_to_numpy(scene.state)
    jcarry = jstepper.advance_to(jstepper.init(j_make_state(pos, vel, mass,
                                                            ids)), t_end)
    assert carry.n_steps == int(jcarry.n_steps) == 21
    assert carry.state.time == float(jcarry.state.time)
    aux = stepper.checkpoint_aux(carry)
    assert aux["n_steps"] == 21 and aux["acc"] is carry.acc


def test_velocity_dispersion_matches_jax():
    pos, vel, mass, ids = numpy_plummer(128, seed=3)
    mask = (np.arange(128) % 3 != 0).astype(np.float64)
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    jstate = j_make_state(pos, vel, mass, ids)
    for m in (None, mask):
        got = tdiag.velocity_dispersion_1d(
            state, None if m is None else torch.from_numpy(m))
        want = jdiag.velocity_dispersion_1d(jstate, m)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
