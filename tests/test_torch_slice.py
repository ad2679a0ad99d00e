"""The ported main path as a whole, against the JAX package.

One numpy Plummer IC goes through both packages on the c1 scene (isolated,
N=256) and on the north-star scene (Milky Way, circular 8 kpc orbit, N
overridden to 512): place_on_orbit -> LeapfrogKDK for 64 steps ->
compute_all. The two differ only by f32 pair-summation order, so
positions agree to 1e-9 of the cluster size (measured: ~5e-11) and every
diagnostics column to 1e-6 relative (measured: <= 6e-8; N_bound within
±1, and the components of L to 1e-9 of |L|). Also: the CLI on
c1, the refusals of what is not ported, and that the port imports no JAX.
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
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import diagnostics as tdiag
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.interop import state_from_numpy, state_to_numpy
from oc_nbody_tpu_torch.run import _to_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C1 = os.path.join(REPO, "configs", "c1_plummer_1k.toml")
NORTH_STAR = os.path.join(REPO, "configs", "north_star_65k_orbit.toml")
N_STEPS = 64


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


def _both(path, n, seed):
    """(JAX row, port row, JAX final pos, port final pos, cluster size)."""
    over = [f"ic.n={n}"]
    cfg_j = jconfig.apply_overrides(jconfig.load_config(path), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(path), over)
    pos, vel, mass, ids = numpy_plummer(n, seed)
    fr = cfg_j.output.fractions

    us = jscene.build_units(cfg_j)
    ext = jscene.build_external_potential(cfg_j, us)
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), ext,
                                  cfg_j, us)
    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=ext, backend="jnp")
    stepper = JLeapfrogKDK(force=force, dt=cfg_j.integrator.dt)
    carry = jax.jit(stepper.advance, static_argnums=1)(stepper.init(state),
                                                       N_STEPS)
    row_j = jax.device_get(jax.jit(
        lambda s: jdiag.compute_all(s, force, fr))(carry.state))
    pos_j = np.asarray(carry.state.pos)

    tus = tscene.build_units(cfg_t)
    text = tscene.build_external_potential(cfg_t, tus)
    tstate = tscene.place_on_orbit(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), text, cfg_t, tus)
    tforce = t_make_force_model(cfg_t.integrator.eps, tus.G, text)
    tstepper = LeapfrogKDK(force=tforce, dt=cfg_t.integrator.dt)
    tcarry = tstepper.advance(tstepper.init(tstate), N_STEPS)
    assert tcarry.n_steps == N_STEPS
    assert tcarry.state.time == float(carry.state.time)
    row_t = _to_host(tdiag.compute_all(tcarry.state, tforce, fr))
    size = float(np.abs(pos - pos.mean(axis=0)).max())
    return row_j, row_t, pos_j, tcarry.state.pos.numpy(), size


@pytest.mark.parametrize("path,n", [(C1, 256), (NORTH_STAR, 512)],
                         ids=["c1", "north_star"])
def test_slice_matches_jax(path, n):
    row_j, row_t, pos_j, pos_t, size = _both(path, n, seed=n)
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-9 * size)
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
            else 0.0
        np.testing.assert_allclose(v, ref, rtol=rtol, atol=atol, err_msg=k)


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


def test_cli_info_and_refusals(capsys):
    assert tmain.main(["info", C1, "--set", "ic.n=64"]) == 0
    assert '"n": 64' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A3"):
        tmain.main(["run", C1, "--device", "cpu", "--resume"])
    with pytest.raises(NotImplementedError, match="A16"):
        tmain.main(["ensemble", C1, "--seeds", "0:2"])
    with pytest.raises(ValueError, match="JAX backend"):
        tmain.main(["run", C1, "--device", "cpu", "--set", "backend=jnp"])
    with pytest.raises(NotImplementedError, match="A11"):
        tmain.main(["run", C1, "--device", "cpu", "--set",
                    "integrator.kind=hermite"])
    with pytest.raises(NotImplementedError, match="A10"):
        tmain.main(["run", C1, "--device", "cpu", "--set", "ic.kind=king"])


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
