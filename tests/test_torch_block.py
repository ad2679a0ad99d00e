"""The port's block-timestep Hermite-4 stepper against the JAX package's.

* The rung selector. The port picks the largest power of two <= x exactly
  (frexp); the JAX package takes floor(jnp.log2(x)), which can round down
  at an exact power of two. On random x the two agree everywhere; at the
  exact powers the port returns the power itself.
* The step math. Both steppers get the same f64 direct-sum forces (each
  package's own rows oracle, and on the orbit case the Milky Way field's
  external jerk: the port's closed form against ``jax.jvp``), so what is
  compared is the integer grid, prediction, correction, the split Aarseth
  criterion, the rung rules, compaction and PEC². Over 64+ micro-steps the
  t_i and dt_i arrays are equal at every micro-step (so are the t_next
  sequence and the active sets), and positions and velocities agree to
  1e-12 of the cluster size (measured ~1e-16).
* The force path. With each package's own f32 force model (the JAX jnp
  ops, the port's plain twins) the pair sums differ in order, ~1e-7·|a|
  apart, and the Aarseth criterion amplifies that, so a rung can flip:
  across seeds 7-12 and 6 or 8 levels, advance_to(1/16) took as many
  micro-steps in both, n_active_sum differed by at most 1 and positions by
  at most 9.3e-11 of the cluster size; the test holds 1e-9 of it, n_steps
  exactly and n_active_sum to 1%.
* Compaction, the uniform limit (n_levels = 1 is the fixed-dt Hermite4),
  checkpoints (restore onto a finer grid, refusals), and c4 through the
  port's run() from a JAX-built state at N = 512.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.forces import make_force_model as j_make_force_model
from oc_nbody_tpu.integrators import block as jblock
from oc_nbody_tpu.ops import gravity as jgrav
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import run as trun
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model as t_make_force_model
from oc_nbody_tpu_torch.integrators import block as tblock
from oc_nbody_tpu_torch.integrators.hermite import Hermite4
from oc_nbody_tpu_torch.interop import (block_carry_from_numpy,
                                        block_carry_to_numpy,
                                        state_from_numpy, state_to_numpy)
from oc_nbody_tpu_torch.ops import gravity as tgrav

from test_torch_orbit import C4
from test_torch_slice import numpy_plummer

EPS = 1.0 / 64
KW = dict(dt_max=1.0 / 16, n_levels=6, eta=0.02)


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass(frozen=True)
class JaxDirectForce:
    """The JAX package's f64 oracles as a block force model."""
    eps: float
    G: float = 1.0
    external: object = None

    def at_time(self, t):
        return self

    def accel_jerk(self, pos, vel, mass):
        acc, jerk = jgrav.accel_jerk_direct(pos, vel, mass, self.eps, self.G)
        return self._ext(acc, jerk, pos, vel)

    def accel_jerk_on_rows(self, pos_rows, vel_rows, src_pos, src_vel, mass,
                           rows_mask=None):
        acc, jerk = jgrav.accel_jerk_rows(pos_rows, vel_rows, src_pos,
                                          src_vel, mass, self.eps, self.G)
        return self._ext(acc, jerk, pos_rows, vel_rows)

    def _ext(self, acc, jerk, pos, vel):
        if self.external is None:
            return acc, jerk
        a, j = self.external.accel_jerk_ext(pos, vel)
        return acc + a, jerk + j


@dataclasses.dataclass(frozen=True)
class PortDirectForce:
    """The port's f64 oracles as a block force model (sources centred as
    the f32 model centres them, without the cast)."""
    eps: float
    G: float = 1.0
    external: object = None

    def at_time(self, t):
        return self

    def accel_jerk(self, pos, vel, mass):
        acc, jerk = tgrav.accel_jerk_direct(pos, vel, mass, self.eps, self.G)
        if self.external is None:
            return acc, jerk
        a, j = self.external.accel_jerk_ext(pos, vel)
        return acc + a, jerk + j

    def centred_sources(self, src_pos, src_vel, mass):
        c, vc = src_pos.mean(0), src_vel.mean(0)
        return src_pos - c, src_vel - vc, mass.double(), c, vc

    def pair_accel_jerk_rows(self, rows, vrows, src, svel, mass):
        return tgrav.accel_jerk_rows(rows, vrows, src, svel, mass, self.eps,
                                     self.G)


def _c4_orbit(pos, vel, mass, ids):
    """c4's Milky Way and eccentric inclined orbit, for both packages."""
    cfg_j, cfg_t = jconfig.load_config(C4), tconfig.load_config(C4)
    us = jscene.build_units(cfg_j)
    jext = jscene.build_external_potential(cfg_j, us)
    text = tscene.build_external_potential(cfg_t, tscene.build_units(cfg_t))
    state = jscene.place_on_orbit(j_make_state(pos, vel, mass, ids), jext,
                                  cfg_j, us)
    return np.array(state.pos), np.array(state.vel), jext, text


def _jax_fields(c):
    s = c.state
    return tuple(np.asarray(x) for x in (
        s.pos, s.vel, s.mass, s.ids, s.time, c.acc, c.jerk, c.a_ext, c.j_ext,
        c.t_i, c.dt_i, c.t_origin, c.n_steps, c.n_active_sum))


def test_accel_jerk_on_rows_matches_jax():
    """ForceModel.accel_jerk_on_rows on c4's orbit (rows a subset of the
    sources, centred on the unweighted source mean, the external field on
    the raw rows) against the JAX package's f32 jnp path, to the f32 pair
    tolerances of max|pairwise a| and |j|; the stepper's split path (rows
    gathered from the centred sources, the field added apart) gives the
    same numbers; an unpruned model ignores rows_mask (the pruning
    membership), as the JAX package's does."""
    pos, vel, mass, ids = numpy_plummer(256, seed=13)
    pos, vel, jext, text = _c4_orbit(pos, vel, mass, ids)
    rows = np.sort(np.random.default_rng(1).choice(256, 37, replace=False))
    jf = j_make_force_model(eps=EPS, external=jext, backend="jnp")
    tf = t_make_force_model(EPS, 1.0, text)
    want = jf.accel_jerk_on_rows(pos[rows], vel[rows], pos, vel, mass)
    p64, v64 = torch.from_numpy(pos), torch.from_numpy(vel)
    m32 = torch.from_numpy(mass)
    got = tf.accel_jerk_on_rows(p64[rows], v64[rows], p64, v64, m32)
    pair = jgrav.accel_jerk_rows(pos[rows], vel[rows], pos, vel, mass, EPS)
    for g, w, pr, tol in zip(got, want, pair, (5e-6, 1e-5)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol * np.abs(np.asarray(pr)).max())
    stepper = tblock.BlockHermite(force=tf, **KW)
    sources = tf.centred_sources(p64, v64, m32)[:3]
    idx = torch.from_numpy(rows)
    pair = stepper._pair(tf, sources, idx, len(rows))
    a1, j1, _, _ = stepper._total(tf, p64, v64, pair)
    for g, w in ((a1[idx], got[0]), (j1[idx], got[1])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-14, atol=0)
    masked = tf.accel_jerk_on_rows(p64[rows], v64[rows], p64, v64, m32,
                                   rows_mask=torch.zeros(len(rows)))
    for g, w in zip(masked, got):
        assert torch.equal(g, w)


def test_accel_jerk_on_rows_extended_matches_jax(monkeypatch):
    """The same at the extended tier: the JAX package through
    accel_jerk_rows_x and its Pallas kernel #12 (interpret mode), the port
    through K9's twin. Held to JAX at the f32 pair tolerances and to the f64
    rows oracle at the tier's bounds (2e-5 of max|a|, 5e-5 of max|j|). The
    stepper's split path (the sources' eight hi/lo planes, rows by gather)
    gives the same numbers, and compacted micro-steps equal masked ones."""
    import oc_nbody_tpu.ops.pallas_gravity as pg
    monkeypatch.setenv("OCN_PALLAS_INTERPRET", "1")
    pg.accel_jerk_rows_x.clear_cache()
    pos, vel, mass, ids = numpy_plummer(256, seed=13)
    pos, vel, jext, text = _c4_orbit(pos, vel, mass, ids)
    rows = np.sort(np.random.default_rng(1).choice(256, 37, replace=False))
    jf = j_make_force_model(eps=EPS, external=jext, backend="pallas",
                            precision="extended")
    tf = t_make_force_model(EPS, 1.0, text, precision="extended")
    try:
        want = jf.accel_jerk_on_rows(pos[rows], vel[rows], pos, vel, mass)
    finally:
        pg.accel_jerk_rows_x.clear_cache()
    p64, v64 = torch.from_numpy(pos), torch.from_numpy(vel)
    m32 = torch.from_numpy(mass)
    got = tf.accel_jerk_on_rows(p64[rows], v64[rows], p64, v64, m32)
    pair = jgrav.accel_jerk_rows(pos[rows], vel[rows], pos, vel, mass, EPS)
    jerk_ext = jext.accel_jerk_ext(pos[rows], vel[rows])
    for g, w, pr, ex, tol, tol64 in zip(got, want, pair, jerk_ext,
                                        (5e-6, 1e-5), (2e-5, 5e-5)):
        assert g.dtype == torch.float64
        scale = np.abs(np.asarray(pr)).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol * scale)
        np.testing.assert_allclose(g.numpy(), np.asarray(pr + ex), rtol=0,
                                   atol=tol64 * scale)
    stepper = tblock.BlockHermite(force=tf, **KW)
    sources = tf.centred_sources(p64, v64, m32)[:-2]
    assert len(sources) == 5 and all(t.dtype == torch.float32
                                     for t in sources)
    idx = torch.from_numpy(rows)
    pair = stepper._pair(tf, sources, idx, len(rows))
    assert pair.dtype == torch.float32 and pair.shape == (2, 256, 3)
    a1, j1, _, _ = stepper._total(tf, p64, v64, pair)
    for g, w in ((a1[idx], got[0]), (j1[idx], got[1])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-14, atol=0)
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    runs = [tblock.BlockHermite(force=tf, n_buckets=nb, **KW)
            for nb in (4, 0)]
    c, m = (r.advance(r.init(state), 12) for r in runs)
    assert c.n_active_sum == m.n_active_sum and c.state.time == m.state.time
    assert torch.equal(c.t_i, m.t_i) and torch.equal(c.dt_i, m.dt_i)
    torch.testing.assert_close(c.state.pos, m.state.pos, rtol=1e-13, atol=0)


def test_rung_selector_matches_jax_off_the_powers_of_two():
    js = jblock.BlockHermite(force=None, dt_max=1.0 / 64, n_levels=8)
    ts = tblock.BlockHermite(force=None, dt_max=1.0 / 64, n_levels=8)
    rng = np.random.default_rng(3)
    # log-uniform over three rungs below dt_min to three above dt_max
    x = js.dt_min * 2.0 ** rng.uniform(-3.0, 10.0, 10_000)
    x = np.concatenate([x, [0.0, 1e-300, js.dt_min, js.dt_min * 1.5,
                            js.dt_max * 3.0, 1e300, np.inf]])
    want = np.asarray(jax.jit(js._rung_from_float)(jnp.asarray(x)))
    got = ts._rung_from_float(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # clamps: below dt_min -> 1, past dt_max -> 2^(n_levels-1)
    assert got[-7] == got[-6] == got[-5] == 1 and got[-4] == 1
    assert got[-3] == got[-2] == got[-1] == 128
    # the exact powers of two: the power itself (jnp.log2 may round down)
    powers = ts.dt_min * 2.0 ** np.arange(8)
    np.testing.assert_array_equal(
        ts._rung_from_float(torch.from_numpy(powers)).numpy(),
        2 ** np.arange(8))


VARIANTS = {"plain": {}, "orbit": {}, "pec2": {"pec2": True},
            "masked": {"n_buckets": 0}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_micro_steps_match_jax_given_f64_forces(variant):
    pos, vel, mass, ids = numpy_plummer(256, seed=5)
    size = float(np.abs(pos).max())
    jext = text = None
    if variant == "orbit":
        pos, vel, jext, text = _c4_orbit(pos, vel, mass, ids)
    kw = dict(KW, **VARIANTS[variant])
    js = jblock.BlockHermite(force=JaxDirectForce(EPS, external=jext), **kw)
    ts = tblock.BlockHermite(force=PortDirectForce(EPS, external=text), **kw)
    jc = js.init(j_make_state(pos, vel, mass, ids))
    tc = ts.init(state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"))
    np.testing.assert_array_equal(tc.dt_i.numpy(), np.asarray(jc.dt_i))
    jstep = jax.jit(js.step)
    for _ in range(64):
        jc, tc = jstep(jc), ts.step(tc)
        # the same t_next, active set and new rungs at every micro-step
        assert tc.state.time == float(jc.state.time)
        np.testing.assert_array_equal(tc.t_i.numpy(), np.asarray(jc.t_i))
        np.testing.assert_array_equal(tc.dt_i.numpy(), np.asarray(jc.dt_i))
    assert tc.n_steps == int(jc.n_steps) == 64
    assert tc.n_active_sum == int(jc.n_active_sum)
    for got, want in ((tc.state.pos, jc.state.pos),
                      (tc.state.vel, jc.state.vel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12 * size)


def test_force_path_matches_jax_from_a_jax_carry():
    """From a JAX-built carry (carried across by interop), both packages'
    f32 force paths: 64 micro-steps and advance_to(1/16) on c4's rungs."""
    pos, vel, mass, ids = numpy_plummer(256, seed=9)
    size = float(np.abs(pos).max())
    for kw in (KW, dict(KW, dt_max=1.0 / 64, n_levels=8)):
        js = jblock.BlockHermite(force=j_make_force_model(eps=EPS,
                                                          backend="jnp"), **kw)
        ts = tblock.BlockHermite(force=t_make_force_model(EPS, 1.0), **kw)
        j0 = js.init(j_make_state(pos, vel, mass, ids))
        t0 = block_carry_from_numpy(*_jax_fields(j0), device="cpu")
        jc = jax.jit(js.advance_to)(j0, 1.0 / 16)
        tc = ts.advance_to(t0, 1.0 / 16)
        assert tc.n_steps == int(jc.n_steps) >= 32
        assert tc.state.time == float(jc.state.time) == 1.0 / 16
        np.testing.assert_allclose(tc.n_active_sum, int(jc.n_active_sum),
                                   rtol=1e-2)
        np.testing.assert_allclose(tc.state.pos.numpy(),
                                   np.asarray(jc.state.pos), rtol=0,
                                   atol=1e-9 * size)


def test_block_carry_round_trips_through_numpy():
    pos, vel, mass, ids = numpy_plummer(64, seed=4)
    js = jblock.BlockHermite(force=JaxDirectForce(EPS), **KW)
    fields = _jax_fields(jax.jit(js.step)(js.init(j_make_state(pos, vel,
                                                               mass, ids))))
    tc = block_carry_from_numpy(*fields, device="cpu")
    assert tc.t_i.dtype == tc.dt_i.dtype == torch.int64
    for got, want in zip(block_carry_to_numpy(tc), fields):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_compacted_equals_masked():
    """The compacted active rows and the masked full-row evaluation give
    the same micro-steps bit for bit (a row's force does not depend on the
    other rows evaluated with it)."""
    pos, vel, mass, ids = numpy_plummer(96, seed=19)
    force = t_make_force_model(1.0 / 32, 1.0)
    kw = dict(dt_max=1.0 / 32, n_levels=4, eta=0.01)
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    comp = tblock.BlockHermite(force=force, **kw)
    mask = tblock.BlockHermite(force=force, n_buckets=0, **kw)
    c1, c2 = comp.advance(comp.init(state), 40), mask.advance(mask.init(state),
                                                              40)
    assert c1.n_active_sum == c2.n_active_sum < 40 * 96
    for a, b in ((c1.state.pos, c2.state.pos), (c1.state.vel, c2.state.vel),
                 (c1.acc, c2.acc), (c1.t_i, c2.t_i), (c1.dt_i, c2.dt_i)):
        assert torch.equal(a, b)


def test_uniform_equivalence_with_hermite():
    """n_levels = 1 puts every particle on dt_max: the port's fixed-dt
    Hermite4 trajectory (tests/physics/test_block.py:15-35 for JAX)."""
    pos, vel, mass, ids = numpy_plummer(64, seed=17)
    force = t_make_force_model(1.0 / 32, 1.0)
    h = 1.0 / 64
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    block = tblock.BlockHermite(force=force, dt_max=h, n_levels=1)
    bc = block.advance(block.init(state), 16)
    herm = Hermite4(force=force, eta=1e12, dt_max=h)
    hc = herm.advance(herm.init(state).replace(dt=h), 16)
    assert bc.n_active_sum == 16 * 64
    assert bc.state.time == hc.state.time == pytest.approx(16 * h, rel=1e-15)
    for a, b in ((bc.state.pos, hc.state.pos), (bc.state.vel, hc.state.vel)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)


def test_restore_rescales_refuses_and_resumes_bitwise():
    pos, vel, mass, ids = numpy_plummer(64, seed=31)
    force = t_make_force_model(1.0 / 32, 1.0)
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    coarse = tblock.BlockHermite(force=force, dt_max=1.0 / 32, n_levels=4)
    mid = coarse.advance(coarse.init(state), 20)
    aux = coarse.checkpoint_aux(mid)
    assert set(aux) == set(tblock._AUX_KEYS)
    # a resume on the same grid continues bit for bit
    ref = coarse.advance(mid, 20)
    again = coarse.advance(coarse.restore(mid.state, aux), 20)
    for a, b in ((ref.state.pos, again.state.pos), (ref.t_i, again.t_i)):
        assert torch.equal(a, b)
    assert again.n_steps == ref.n_steps == 40

    # onto a finer grid: per-particle times kept, rungs clamped
    mid = coarse.advance_to(coarse.init(state), 1.0 / 32)
    aux = coarse.checkpoint_aux(mid)
    fine = tblock.BlockHermite(force=force, dt_max=1.0 / 64, n_levels=5)
    c = fine.restore(mid.state, aux)
    np.testing.assert_array_equal(c.t_i.numpy() * fine.dt_min,
                                  mid.t_i.numpy() * coarse.dt_min)
    assert int(c.dt_i.max()) <= 16
    c = fine.advance_to(c, 3.0 / 32)
    assert c.state.time == pytest.approx(3.0 / 32, rel=1e-12)
    assert fine.reached(c, 3.0 / 32) and not fine.reached(c, 4.0 / 32)

    # the same rescale as the JAX package's restore
    jc = jblock.BlockHermite(force=JaxDirectForce(1.0 / 32), dt_max=1.0 / 32,
                             n_levels=4)
    jmid = jax.jit(jc.advance_to)(jc.init(j_make_state(pos, vel, mass, ids)),
                                  1.0 / 32)
    jaux = {k: np.asarray(v) for k, v in jc.checkpoint_aux(jmid).items()}
    jfine = jblock.BlockHermite(force=JaxDirectForce(1.0 / 32),
                                dt_max=1.0 / 64, n_levels=5)
    want = jfine.restore(jmid.state, jaux)
    got = fine.restore(state_from_numpy(*_jax_fields(jmid)[:5], "cpu"), jaux)
    np.testing.assert_array_equal(got.t_i.numpy(), np.asarray(want.t_i))
    np.testing.assert_array_equal(got.dt_i.numpy(), np.asarray(want.dt_i))

    # coarsening and a partial aux are refused
    with pytest.raises(ValueError, match="does not embed"):
        coarse.restore(c.state, fine.checkpoint_aux(c))
    for drop in ("a_ext", "n_levels", "t_i"):
        partial = {k: v for k, v in aux.items() if k != drop}
        with pytest.raises(ValueError, match=f"lacks \\['{drop}'\\]"):
            fine.restore(mid.state, partial)


def test_rung_occupancy_matches_jax():
    pos, vel, mass, ids = numpy_plummer(128, seed=23)
    js = jblock.BlockHermite(force=JaxDirectForce(EPS), **KW)
    jc = jax.jit(js.advance_to)(js.init(j_make_state(pos, vel, mass, ids)),
                                1.0 / 16)
    ts = tblock.BlockHermite(force=PortDirectForce(EPS), **KW)
    tc = block_carry_from_numpy(*_jax_fields(jc), device="cpu")
    occ = ts.rung_occupancy(tc)
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(js.rung_occupancy(jc)))
    assert int(occ.sum()) == 128 and len(occ) == KW["n_levels"]


def test_c4_slice_through_run(monkeypatch, capsys):
    """c4 at N = 512 through the port's run() on the CPU, from the JAX
    package's c4 state (its Plummer sample placed on the eccentric inclined
    orbit): the output grid snaps to dt_max, every row has the rung
    columns, and the drift stays in c4's class. The JAX stepper from the
    same state lands on t_end with the same energy to 1e-9 of E_int."""
    over = ["ic.n=512", "output.t_end=0.25", "output.diag_every=0.1"]
    cfg_j = jconfig.apply_overrides(jconfig.load_config(C4), over)
    cfg_t = tconfig.apply_overrides(tconfig.load_config(C4), over)
    us = jscene.build_units(cfg_j)
    jext = jscene.build_external_potential(cfg_j, us)
    jstate = jscene.place_on_orbit(jscene.build_ic(cfg_j, us), jext, cfg_j,
                                   us)
    fields = tuple(np.asarray(x) for x in (jstate.pos, jstate.vel,
                                           jstate.mass, jstate.ids,
                                           jstate.time))
    real_build = trun.build_scene

    def jax_state_scene(cfg, device):
        scene = real_build(cfg, device)
        scene.state = state_from_numpy(*fields, device)
        return scene

    monkeypatch.setattr(trun, "build_scene", jax_state_scene)
    res = trun.run(cfg_t, device="cpu")
    out = capsys.readouterr().out
    assert "block grid: snapped {'diag_every': 0.1} -> {'diag_every': " \
           "0.09375}" in out
    d = res.diagnostics
    np.testing.assert_allclose(d["time"], [0.0, 0.09375, 0.1875, 0.25],
                               rtol=1e-14)
    rungs = [f"rung_{k:02d}" for k in range(8)]
    assert all(r in d for r in rungs) and "rung_08" not in d
    np.testing.assert_array_equal(sum(d[r] for r in rungs), 512.0)
    assert res.n_steps <= 0.25 * 8192
    assert 0 < res.n_active_sum < res.n_steps * 512
    assert np.abs(d["dE_over_E_int"]).max() < 2e-5

    force = j_make_force_model(eps=cfg_j.integrator.eps, G=us.G,
                               external=jext, backend="jnp")
    jstepper, _ = jscene.make_stepper(cfg_j, force)
    jc = jax.jit(jstepper.advance_to)(jstepper.init(jstate), 0.25)
    assert float(jc.state.time) == res.state.time == 0.25
    from oc_nbody_tpu import diagnostics as jdiag
    e_j = float(jdiag.energies(jc.state, force)["E_tot"])
    e_int0 = abs(float(d["E_int"][0]))
    assert abs(d["E_tot"][-1] - e_j) < 1e-6 * e_int0
    pos_t = state_to_numpy(res.state)[0]
    size = float(np.abs(fields[0] - fields[0].mean(axis=0)).max())
    np.testing.assert_allclose(pos_t, np.asarray(jc.state.pos), rtol=0,
                               atol=1e-8 * size)
