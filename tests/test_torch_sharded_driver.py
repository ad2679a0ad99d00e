"""Steppers, the run loop and the CLI on a mesh: the port's ShardedForce
under KDK and Hermite against the port's unsharded force from the same
state and against the JAX package's ShardedForce, on the CPU.

A numpy Plummer IC of 250 stars (ragged against 8 d rows) is put on
c5_131k_sharded's circular orbit in its Milky Way by the JAX package's
``place_on_orbit`` and carried into the port (``interop.py``). KDK: 20 steps
of c5's dt = 1/1024 in each of the four modes on 4 CPU shards, held to the
unsharded port run and to the JAX package's sharded run in the same mode
(``rdma``: its Pallas ring in interpret mode), with bounds set by the f32
pair sums' rounding (``_kdk_bounds``): only the summation order differs.
Hermite (c3's stepper): through f32 forces the Aarseth criterion amplifies summation-order rounding, so, as ROADMAP §C "Adaptive
steps" says, step counts are not compared: the dt sequences agree to 2%
(tests/test_torch_hermite.py's measured 1%), the ``rdma`` and ``ring``
runs land on t = 0.03 by ``advance_to`` with positions within 1e-8 of the
cluster size of the unsharded run's and of the JAX package's ring-mode
run's, and the sharded forces at the landing state are held to the f64
oracle. Then
``run.run`` with an API mesh on c5 (f32 rows through K20<phi>'s twin, and
``diag_f64`` rows on the global state), the refusals, raised before any
IC is built, and ``info``'s mesh line.
"""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.integrators import hermite as jhermite
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK as JLeapfrogKDK
from oc_nbody_tpu.parallel import make_mesh as j_make_mesh
from oc_nbody_tpu.parallel import make_sharded_force as j_make_sharded_force
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import run as trun
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators import hermite as thermite
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import gravity as tgravity
from oc_nbody_tpu_torch.parallel.force import make_sharded_force
from oc_nbody_tpu_torch.parallel.mesh import Mesh
from test_torch_sharded import pallas_interpret
from test_torch_slice import REPO, numpy_plummer

C5 = os.path.join(REPO, "configs", "c5_131k_sharded.toml")
N = 250
D = 4
MODES = ("allgather", "ring", "rdma", "halfring")
HERMITE = dict(eta=0.02, eta_init=0.01, dt_max=1.0 / 16)   # c3's


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def orbit():
    """(numpy IC on c5's orbit, JAX field, port field, G, eps, dt)."""
    pos, vel, mass, ids = numpy_plummer(N, seed=21)
    jcfg, tcfg = jconfig.load_config(C5), tconfig.load_config(C5)
    us = jscene.build_units(jcfg)
    jext = jscene.build_external_potential(jcfg, us)
    text = tscene.build_external_potential(tcfg, tscene.build_units(tcfg))
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), jext,
                                  jcfg, us)
    ic = (np.asarray(state.pos), np.asarray(state.vel), mass, ids)
    return ic, jext, text, us.G, tcfg.integrator.eps, tcfg.integrator.dt


def _jax_sharded(mode, jext, G, eps):
    return j_make_sharded_force(
        eps=eps, G=G, external=jext, mesh=j_make_mesh(D), mode=mode,
        backend="pallas" if mode == "rdma" else "jnp")


def _port_sharded(mode, text, G, eps):
    return make_sharded_force(eps, G, text, mesh=Mesh.on_one_device(D, "cpu"),
                              mode=mode)


def _kdk_bounds(ic, G, eps, t):
    """(pos, vel) tolerances of two KDK runs whose f32 pair sums differ in
    order only: 1e-6 of max|a_pair| (ten times the f32 rounding of the
    sums), integrated over t for the velocities and t^2 for the positions.
    Measured at 20 steps: 2e-11-8e-11 and 3e-9-1e-8, against bounds of
    2e-9 and 1e-7."""
    state = state_from_numpy(*ic, 0.0, "cpu")
    a_max = float(tgravity.accel_direct(state.pos, state.mass.double(), eps,
                                        G).abs().max())
    return 1e-6 * a_max * t * t, 1e-6 * a_max * t


@pytest.mark.parametrize("mode", MODES)
def test_kdk_on_four_shards_matches_unsharded_and_jax(orbit, mode):
    ic, jext, text, G, eps, dt = orbit
    start = state_from_numpy(*ic, 0.0, "cpu")
    sharded = LeapfrogKDK(force=_port_sharded(mode, text, G, eps), dt=dt)
    single = LeapfrogKDK(force=t_make_force_model(eps, G, text), dt=dt)
    got = sharded.advance(sharded.init(start), 20)
    ref = single.advance(single.init(start), 20)
    assert got.n_steps == 20 and got.state.time == ref.state.time
    tol = dict(zip(("pos", "vel"), _kdk_bounds(ic, G, eps, got.state.time)))
    for name in ("pos", "vel"):
        np.testing.assert_allclose(
            getattr(got.state, name).numpy(), getattr(ref.state, name).numpy(),
            rtol=0, atol=tol[name], err_msg=f"{mode} {name} unsharded")
    with pallas_interpret() if mode == "rdma" else contextlib.nullcontext():
        js = JLeapfrogKDK(force=_jax_sharded(mode, jext, G, eps), dt=dt)
        jstep = jax.jit(js.step)
        jc = jax.jit(js.init)(j_make_state(*ic))
        for _ in range(20):
            jc = jstep(jc)
        jpos, jvel = np.asarray(jc.state.pos), np.asarray(jc.state.vel)
    np.testing.assert_allclose(got.state.pos.numpy(), jpos, rtol=0,
                               atol=tol["pos"], err_msg=f"{mode} pos JAX")
    np.testing.assert_allclose(got.state.vel.numpy(), jvel, rtol=0,
                               atol=tol["vel"], err_msg=f"{mode} vel JAX")


@pytest.mark.parametrize("mode", ("rdma", "ring"))
def test_hermite_on_four_shards_matches_unsharded_and_jax(orbit, mode):
    ic, jext, text, G, _, _ = orbit
    eps = 1.0 / 256
    size = float(np.abs(ic[0] - ic[0].mean(0)).max())
    start = state_from_numpy(*ic, 0.0, "cpu")
    force = _port_sharded(mode, text, G, eps)
    sharded = thermite.Hermite4(force=force, **HERMITE)
    single = thermite.Hermite4(force=t_make_force_model(eps, G, text),
                               **HERMITE)
    dts = []
    for stepper in (sharded, single):
        c = stepper.init(start)
        seq = [c.dt]
        for _ in range(16):
            c = stepper.step(c)
            seq.append(c.dt)
        dts.append(np.array(seq))
    np.testing.assert_allclose(dts[0], dts[1], rtol=2e-2, atol=0)
    t_end = 0.03
    got = sharded.advance_to(sharded.init(start), t_end)
    ref = single.advance_to(single.init(start), t_end)
    assert got.state.time == ref.state.time == t_end
    np.testing.assert_allclose(got.state.pos.numpy(), ref.state.pos.numpy(),
                               rtol=0, atol=1e-8 * size)
    # the JAX run in ring mode: its Pallas ring in interpret mode takes
    # half a minute over this run (the KDK test holds rdma to it)
    js = jhermite.Hermite4(force=_jax_sharded("ring", jext, G, eps),
                           **HERMITE)
    jc = jax.jit(js.advance_to)(jax.jit(js.init)(j_make_state(*ic)), t_end)
    jpos = np.asarray(jc.state.pos)
    assert float(jc.state.time) == t_end
    np.testing.assert_allclose(got.state.pos.numpy(), jpos, rtol=0,
                               atol=1e-8 * size)
    # the sharded forces at the landing state against the f64 oracle
    s = got.state
    acc, jerk = force.accel_jerk(s.pos, s.vel, s.mass)
    a64, j64 = tgravity.accel_jerk_direct(s.pos, s.vel,
                                          s.mass.to(torch.float64), eps, G)
    a_ext, j_ext = text.accel_jerk_ext(s.pos, s.vel)
    assert float((acc - a64 - a_ext).abs().max()) < 5e-6 * float(
        a64.abs().max())
    assert float((jerk - j64 - j_ext).abs().max()) < 5e-5 * float(
        j64.abs().max())


def _c5(*overrides):
    return tconfig.apply_overrides(tconfig.load_config(C5), [
        "ic.n=500", "output.t_end=0.015625", "output.diag_every=0.0078125",
        *overrides])


@pytest.mark.parametrize("diag_f64", (True, False))
def test_run_c5_on_an_api_mesh(diag_f64):
    """c5 as committed but for N and length (``mesh.mode = "ring"``, and
    ``rdma``), on 4 CPU shards: 16 KDK steps and 3 rows, each drift inside
    c5's 1e-6 class, d^2 ring launches per force evaluation (K20's twin per
    step and at init; K20<phi>'s per f32 row, K23's once per f64 row), and
    the rows equal to the unsharded run's to the f32 rows' rounding."""
    mesh = Mesh.on_one_device(D, "cpu")
    rows = {}
    for mode in ("ring", "rdma", None):
        cfg = _c5(f"output.diag_f64={str(diag_f64).lower()}",
                  f"output.stdout=false",
                  *([f"mesh.mode={mode}"] if mode else []))
        before = dict(cg.PLAIN_CALLS)
        res = trun.run(cfg, device="cpu", mesh=mesh if mode else None)
        ran = {k: cg.PLAIN_CALLS[k] - before[k] for k in before
               if cg.PLAIN_CALLS[k] != before[k]}
        assert res.n_steps == 16
        d = res.diagnostics
        assert len(d["time"]) == 3
        assert np.abs(d["dE_over_E_int"]).max() < 1e-6
        if mode == "rdma":
            want = {"ring": D * D * 17, "knn_density": 3}   # CH85 per row
            if diag_f64:   # K23's twin on the gathered state, per row
                want["phi_f64"] = 3
            else:
                want["ring_phi"] = D * D * 3
            assert ran == want
        rows[mode] = d
    for mode in ("ring", "rdma"):
        np.testing.assert_allclose(rows[mode]["E_int"], rows[None]["E_int"],
                                   rtol=1e-9 if diag_f64 else 1e-6)


REFUSALS = [
    ("c4_block_32k_eccentric.toml", [], NotImplementedError, "A17a"),
    ("c5x_131k_extended.toml", [], NotImplementedError, "A17b"),
    ("escape_prune_65k.toml", [], NotImplementedError, "A17c"),
    ("c5_131k_sharded.toml", ["integrator.precision=df32"], ValueError,
     "single-device only"),
    ("c5_131k_sharded.toml", ["mesh.mode=rdma",
                              "integrator.precision=extended"], ValueError,
     "f32-only"),
    ("c5_131k_sharded.toml", ["mesh.mode=tree"], ValueError,
     "unknown sharded-force mode"),
]


@pytest.mark.parametrize("config,overrides,error,match", REFUSALS)
def test_mesh_refusals_come_before_any_state(monkeypatch, config, overrides,
                                             error, match):
    def no_ic(*args, **kw):
        raise AssertionError("an IC was built before the refusal")

    monkeypatch.setattr(tscene, "build_ic", no_ic)
    cfg = tconfig.apply_overrides(
        tconfig.load_config(os.path.join(REPO, "configs", config)),
        ["ic.n=256", *overrides])
    mesh = Mesh.on_one_device(D, "cpu")
    with pytest.raises(error, match=match):
        trun.run(cfg, device="cpu", mesh=mesh)
    with pytest.raises(error, match=match):
        tscene.build_scene(cfg, "cpu", mesh=mesh)
    # one shard is the unsharded force: no refusal of the mesh's
    if error is NotImplementedError and config != "escape_prune_65k.toml":
        with pytest.raises(AssertionError, match="IC was built"):
            tscene.build_scene(cfg, "cpu", mesh=Mesh.on_one_device(1, "cpu"))


def test_cli_refuses_more_devices_than_visible(capsys):
    with pytest.raises(ValueError, match="requested 4 devices, only 1 visible"):
        tmain.main(["run", C5, "--device", "cpu", "--set", "ic.n=64",
                    "--set", "mesh.n_devices=4"])
    assert tmain.main(["info", C5, "--set", "mesh.n_devices=4"]) == 0
    out = capsys.readouterr().out
    assert "requested 4 devices, only 1 visible" in out
    assert tmain.main(["info", C5]) == 0
    assert ("mesh: one device (cpu; mesh.n_devices = 0), the unsharded force"
            in capsys.readouterr().out)


def test_info_prints_the_mesh(monkeypatch, capsys):
    """On a machine with four cards c5's mesh.n_devices = 0 resolves to
    four shards: info names them, the mode and the kernels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for mode, kernels in (
            ("ring", "K18: 4 hops per shard, 16 launches in all, of 32768 x "
                     "32768 pairs"),
            ("rdma", "K20 (K20<phi> for the potential): 4 launches per "
                     "shard, 16 in all, of 32768 x 32768 pairs, the slabs "
                     "handed on by 12 copies"),
            ("allgather", "K18: one launch per shard of 32768 x 131072"),
            ("halfring", "K2 on each shard's 32768 rows, K12 on 12")):
        assert tmain.main(["info", C5, "--set", f"mesh.mode={mode}"]) == 0
        out = capsys.readouterr().out
        assert (f"mesh: 4 shards on cuda:0, cuda:1, cuda:2, cuda:3, mode "
                f"{mode}; kernels per force evaluation at N = 131072: "
                f"{kernels}") in out
        assert "kernels on the card at N" not in out
    assert tmain.main(["info", C5, "--set", "integrator.kind=hermite",
                       "--set", "mesh.mode=rdma"]) == 0
    assert "K21: 4 launches per shard" in capsys.readouterr().out
    assert tscene.resolve_mesh(tconfig.load_config(C5), "cuda").n_devices == 4
