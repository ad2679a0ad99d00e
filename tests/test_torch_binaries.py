"""Primordial binaries in the port (``oc_nbody_tpu_torch/models/binaries.py``
and the scene's ``ic.binary_*`` options) against the JAX package, on the
CPU.

  * ``solve_kepler``, ``kepler_orbit_phase`` and ``orbital_elements`` against
    the JAX functions on the same numpy inputs, to 1e-12 (both are f64; the
    Newton iteration and the trigonometry differ in the last bits);
  * ``add_binaries`` fed the JAX package's own draws (this file repeats the
    key split and the six draws of ``oc_nbody_tpu/models/binaries.py``) gives
    the JAX state to 1e-12, with equal masses, ids and pair indices;
  * ``configs/binaries_8k.toml`` builds its 10,650 stars through the port's
    scene, the singles untouched by the binaries' generator; ``a_min < 2
    eps`` is refused;
  * a short block + extended + pec2 run of a cluster with embedded circular
    pairs keeps every pair's semi-major axis to 5e-4 and puts the pairs on
    the deepest rungs, as ``tests/physics/test_block_binary.py`` asks of the
    JAX package;
  * on binaries_8k's IC as the JAX package draws it, both packages'
    ``orbital_elements`` read every pair bound at t = 0 (ROADMAP fault C3).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oc_nbody_tpu.models import binaries as jbin
from oc_nbody_tpu.state import make_state as j_make_state
from oc_nbody_tpu_torch import __main__ as tmain
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.forces import make_force_model
from oc_nbody_tpu_torch.integrators.block import BlockHermite
from oc_nbody_tpu_torch.interop import state_from_numpy
from oc_nbody_tpu_torch.models import binaries as tbin
from test_torch_slice import REPO, numpy_kroupa, numpy_plummer

BIN = os.path.join(REPO, "configs", "binaries_8k.toml")


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _orbits(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    return (np.exp(rng.uniform(np.log(1e-3), np.log(0.05), n)),
            0.95 * np.sqrt(rng.uniform(size=n)),
            rng.uniform(0.0, 2.0 * np.pi, n), rng.uniform(1e-4, 1e-2, n))


def test_solve_kepler_matches_jax_and_solves_the_equation():
    _, e, m, _ = _orbits()
    got = tbin.solve_kepler(torch.from_numpy(m), torch.from_numpy(e)).numpy()
    want = np.asarray(jbin.solve_kepler(jnp.asarray(m), jnp.asarray(e)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got - e * np.sin(got), m, rtol=0, atol=1e-12)


def test_orbit_phase_and_elements_match_jax_and_invert():
    a, e, m, gm = _orbits()
    ta, te, tm, tgm = (torch.from_numpy(x) for x in (a, e, m, gm))
    r, v = tbin.kepler_orbit_phase(ta, te, tm, tgm)
    jr, jv = jbin.kepler_orbit_phase(*(jnp.asarray(x) for x in (a, e, m, gm)))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12,
                               atol=1e-12 * a.max())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jv)).max())
    a2, e2 = tbin.orbital_elements(r, v, tgm)
    ja2, je2 = jbin.orbital_elements(jr, jv, jnp.asarray(gm))
    np.testing.assert_allclose(a2.numpy(), np.asarray(ja2), rtol=1e-12)
    np.testing.assert_allclose(e2.numpy(), np.asarray(je2), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(a2.numpy(), a, rtol=1e-10)
    np.testing.assert_allclose(e2.numpy(), e, rtol=0, atol=1e-9)
    # an unbound pair returns a < 0
    a3, _ = tbin.orbital_elements(r[:4], 3.0 * v[:4], tgm[:4])
    assert bool((a3 < 0).all())


def _jax_draws(key, n, n_b, a_min, a_max, q_min):
    """The draws of oc_nbody_tpu/models/binaries.py:181-191 and :69."""
    k_sel, k_a, k_e, k_q, k_m, k_rot = jax.random.split(key, 6)
    f64 = jnp.float64
    return tbin.BinaryDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.permutation(k_sel, n)[:n_b],
        jax.random.uniform(k_a, (n_b,), f64, jnp.log(a_min), jnp.log(a_max)),
        jax.random.uniform(k_e, (n_b,), f64),
        jax.random.uniform(k_q, (n_b,), f64, q_min, 1.0),
        jax.random.uniform(k_m, (n_b,), f64, 0.0, 2.0 * jnp.pi),
        jax.random.uniform(k_rot, (3, n_b), f64))))


@pytest.mark.parametrize("fraction,e_max", [(0.3, 0.95), (1.0, 0.5)])
def test_add_binaries_from_the_jax_draws_gives_the_jax_state(fraction, e_max):
    n, a_min, a_max, q_min, G = 300, 1e-3, 0.05, 0.1, 1.7
    pos, vel, _, ids = numpy_plummer(n, 31)
    mass = numpy_kroupa(n, 32)
    key = jax.random.PRNGKey(33)
    want = jbin.add_binaries(j_make_state(pos, vel, mass, ids), key, fraction,
                             a_min, a_max, G=G, q_min=q_min, e_max=e_max)
    n_b = int(round(fraction * n))
    got = tbin.add_binaries(
        state_from_numpy(pos, vel, mass, ids, 0.0, "cpu"), None, fraction,
        a_min, a_max, G=G, q_min=q_min, e_max=e_max,
        draws=_jax_draws(key, n, n_b, a_min, a_max, q_min))
    assert got.state.n == n + n_b == want.state.n
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(want.state.pos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.state.vel.numpy(),
                               np.asarray(want.state.vel), rtol=0, atol=1e-12)
    assert got.state.mass.dtype == torch.float32
    np.testing.assert_array_equal(got.state.mass.numpy(),
                                  np.asarray(want.state.mass))
    np.testing.assert_array_equal(got.state.ids.numpy(),
                                  np.asarray(want.state.ids))
    np.testing.assert_array_equal(got.primary_idx.numpy(),
                                  np.asarray(want.primary_idx))
    np.testing.assert_array_equal(got.secondary_idx.numpy(),
                                  np.asarray(want.secondary_idx))
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), rtol=1e-14)
    np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e), rtol=1e-14)
    # mass, momentum and each pair's centre of mass are the parent's
    s = got.state
    m64 = s.mass.double()
    np.testing.assert_allclose(float(m64.sum()),
                               float(mass.astype(np.float64).sum()),
                               rtol=1e-7)
    i, j = got.primary_idx.long(), got.secondary_idx.long()
    com = ((m64[i, None] * s.pos[i] + m64[j, None] * s.pos[j])
           / (m64[i] + m64[j])[:, None])
    np.testing.assert_allclose(com.numpy(), pos[i.numpy()], rtol=0,
                               atol=1e-14)
    a, e = tbin.orbital_elements(s.pos[i] - s.pos[j], s.vel[i] - s.vel[j],
                                 G * (m64[i] + m64[j]))
    np.testing.assert_allclose(a.numpy(), got.a.numpy(), rtol=1e-9)
    np.testing.assert_allclose(e.numpy(), got.e.numpy(), rtol=0, atol=1e-8)


def test_draws_are_a_function_of_the_generator_and_in_range():
    def draw(seed):
        return tbin.draw_binaries(500, 150, torch.Generator().manual_seed(
            seed), 1e-3, 0.05, 0.1)

    d, again, other = draw(7), draw(7), draw(8)
    for name in ("sel", "log_a", "u_e", "q", "mean_anom", "u_rot"):
        assert torch.equal(getattr(d, name), getattr(again, name))
    assert not torch.equal(d.log_a, other.log_a)
    assert len(set(d.sel.tolist())) == 150 and int(d.sel.max()) < 500
    assert np.log(1e-3) <= float(d.log_a.min()) \
        and float(d.log_a.max()) < np.log(0.05)
    assert 0.1 <= float(d.q.min()) and float(d.q.max()) < 1.0
    assert 0.0 <= float(d.mean_anom.min()) \
        and float(d.mean_anom.max()) < 2 * np.pi
    assert d.u_rot.shape == (3, 150)
    rot = tbin._random_rotations(d.u_rot)
    eye = torch.eye(3, dtype=torch.float64).expand(150, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), eye, rtol=0,
                               atol=1e-14)
    torch.testing.assert_close(torch.linalg.det(rot), torch.ones(
        150, dtype=torch.float64), rtol=0, atol=1e-14)
    state = state_from_numpy(*numpy_plummer(64, 2), 0.0, "cpu")
    none = tbin.add_binaries(state, None, 0.0, 1.0, 1.0)
    assert none.state is state and len(none.primary_idx) == 0
    for bad in (dict(fraction=1.5, a_min=1e-3, a_max=0.05),
                dict(fraction=0.3, a_min=0.05, a_max=1e-3),
                dict(fraction=0.3, a_min=1e-3, a_max=0.05, q_min=0.0)):
        with pytest.raises(ValueError):
            tbin.add_binaries(state, torch.Generator(), **bad)


def test_binaries_8k_builds_its_10650_stars_and_refuses_soft_pairs(capsys):
    cfg = tconfig.load_config(BIN)
    scene = tscene.build_scene(cfg, "cpu")
    s = scene.state
    assert s.n == 10650 and scene.force.precision == "extended"
    assert s.ids.tolist() == list(range(10650))
    singles = tscene.build_singles(cfg, scene.units)
    pop = tscene.build_binaries(cfg, scene.units, singles)
    assert singles.n == 8192 and len(pop.primary_idx) == 2458
    # the binaries draw from their own generator: the same systems as the
    # config without them
    alone = tscene.build_singles(tconfig.apply_overrides(
        tconfig.load_config(BIN), ["ic.binary_fraction=0.0"]), scene.units)
    assert torch.equal(alone.pos, singles.pos)
    # every pair is bound, inside the configured elements, and heavier
    # than neither parent
    i, j = pop.primary_idx.long(), pop.secondary_idx.long()
    st = pop.state
    gm = scene.units.G * (st.mass[i] + st.mass[j]).double()
    a, e = tbin.orbital_elements(st.pos[i] - st.pos[j], st.vel[i] - st.vel[j],
                                 gm)
    assert float(a.min()) >= cfg.ic.binary_a_min * (1 - 1e-9)
    assert float(a.max()) <= cfg.ic.binary_a_max * (1 + 1e-9)
    assert float(e.max()) <= cfg.ic.binary_e_max + 1e-9
    np.testing.assert_allclose(float(st.total_mass),
                               float(singles.total_mass), rtol=1e-7)
    assert tmain.main(["info", BIN]) == 0
    out = capsys.readouterr().out
    assert "stepper: block BlockHermite" in out and "'pec2': True" in out
    assert "pairwise precision tier: extended" in out
    with pytest.raises(ValueError, match="below twice the softening"):
        tscene.build_scene(tconfig.apply_overrides(
            tconfig.load_config(BIN),
            ["ic.n=64", "ic.binary_a_min=0.0004"]), "cpu")
    with pytest.raises(ValueError, match="requires ic.binary_a_min"):
        tscene.build_scene(tconfig.apply_overrides(
            tconfig.load_config(os.path.join(
                REPO, "configs", "c1_plummer_1k.toml")),
            ["ic.n=64", "ic.binary_fraction=0.5"]), "cpu")


def test_binaries_8k_runs_through_the_cli_on_cpu(capsys):
    """The config as committed but for N and length: block + extended + pec2
    on 12 rungs through K9's and K7's twins."""
    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    before = dict(cg.PLAIN_CALLS)
    assert tmain.main(["run", BIN, "--device", "cpu", "--set", "ic.n=96",
                       "--set", "output.t_end=0.015625", "--set",
                       "output.diag_every=0.015625"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("t=")][-1]
    steps = int(line.split("steps=")[1].split()[0])
    assert 100 < steps <= 2048                  # 12 rungs under dt_max = 1/64
    # 125 stars with hard pairs, against the total (orbital) energy
    assert abs(float(line.split("dE/E=")[1].split()[0])) < 1e-4
    ran = {k: cg.PLAIN_CALLS[k] - before[k] for k in before
           if cg.PLAIN_CALLS[k] != before[k]}
    # 125 stars: K9's twin at init and twice per micro-step, K8's and
    # K22's (CH85) per row
    assert ran == {"rows_jerk_x": 2 * steps + 1, "rows_x": 2,
                   "knn_density": 2}


def test_block_extended_pec2_keeps_embedded_pairs():
    """192 systems, 19 of them circular pairs of a = 2e-3..3e-3 (periods
    ~1e-2, a hundredth of the cluster's crossing time): after one dt_max
    block every pair's semi-major axis is kept to 5e-4 and its eccentricity
    stays below 0.02, the pairs sit on the deepest rungs in use and the
    typical single far above them. The sample (generator seed 44) has no
    third star within 0.08 of a pair: where one passes at 0.05 it changes
    that pair's a by 1e-3 to 1e-2 in this time (seeds 42 and 43), which is
    the cluster's doing, not the stepper's; the median change is 1e-5 in
    every sample."""
    n = 192
    pos, vel, mass, ids = numpy_plummer(n, 41)
    state = state_from_numpy(pos, vel, mass, ids, 0.0, "cpu")
    pop = tbin.add_binaries(state, torch.Generator().manual_seed(44), 0.1,
                            2e-3, 3e-3, e_max=0.0)
    s = pop.state
    assert s.n == n + 19
    i, j = pop.primary_idx.long(), pop.secondary_idx.long()
    gm = (s.mass[i] + s.mass[j]).double()
    force = make_force_model(1e-4, 1.0, precision="extended")
    block = BlockHermite(force=force, eta=0.01, dt_max=1.0 / 16, n_levels=10,
                         pec2=True)
    carry = block.init(s)
    dt_i = carry.dt_i.numpy()
    members = np.concatenate([i.numpy(), j.numpy()])
    others = np.delete(dt_i, members)
    assert dt_i[members].max() <= 2 * dt_i.min()
    assert np.median(others) >= 8 * dt_i[members].max()
    carry = block.advance_to(carry, 1.0 / 16)
    st = carry.state
    assert st.time == 1.0 / 16 and carry.n_steps <= 512
    a1, e1 = tbin.orbital_elements(st.pos[i] - st.pos[j],
                                   st.vel[i] - st.vel[j], gm)
    np.testing.assert_allclose(a1.numpy(), pop.a.numpy(), rtol=5e-4)
    assert float(e1.max()) < 0.02
    occ = block.rung_occupancy(carry).numpy()
    assert occ[6:].sum() >= 38 and occ[:4].sum() >= 100, occ


def test_binaries_8k_pairs_read_bound_at_t0_in_both_packages():
    """ROADMAP fault C3: 4.3% of binaries_8k's 2,458 pairs read unbound
    (two-body a < 0 or e >= 1) by t = 0.125 at every tier on the card. On
    the IC the JAX package draws (its scene's ``build_ic``), carried
    across, both packages' ``orbital_elements`` read every pair bound, with
    the same elements: the IC and the element code agree. What the run does
    to the pairs is the widest pairs' neighbourhood: 13% of the pairs reach
    apocentre beyond their nearest third star at t = 0 (26% beyond half of
    it), where two-body elements ignore a perturber inside the orbit."""
    import dataclasses
    from oc_nbody_tpu import config as jconfig
    from oc_nbody_tpu import scene as jscene
    cfg = jconfig.load_config(BIN)
    us = jscene.build_units(cfg)
    ic = cfg.ic
    singles = jscene.build_ic(dataclasses.replace(
        cfg, ic=dataclasses.replace(ic, binary_fraction=0.0)), us)
    pop = jbin.add_binaries(
        singles, jax.random.fold_in(jax.random.PRNGKey(ic.seed), 0x42494E),
        fraction=ic.binary_fraction, a_min=ic.binary_a_min,
        a_max=ic.binary_a_max, G=us.G, q_min=ic.binary_q_min,
        e_max=ic.binary_e_max)
    js = pop.state
    assert js.pos.shape[0] == 10650 and pop.primary_idx.shape[0] == 2458
    i, j = np.asarray(pop.primary_idx), np.asarray(pop.secondary_idx)
    pos, vel = np.asarray(js.pos), np.asarray(js.vel)
    m = np.asarray(js.mass).astype(np.float64)
    gm = us.G * (m[i] + m[j])
    ja, je = (np.asarray(x) for x in jbin.orbital_elements(
        pos[i] - pos[j], vel[i] - vel[j], gm))
    ts = state_from_numpy(pos, vel, np.asarray(js.mass), np.asarray(js.ids),
                          0.0, "cpu")
    ti, tj = torch.from_numpy(i.copy()).long(), torch.from_numpy(
        j.copy()).long()
    ta, te = tbin.orbital_elements(ts.pos[ti] - ts.pos[tj],
                                   ts.vel[ti] - ts.vel[tj],
                                   torch.from_numpy(gm))
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-12)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=1e-12)
    bound_j = float(np.mean((ja > 0) & (je < 1)))
    bound_t = float(((ta > 0) & (te < 1)).double().mean())
    assert bound_t == bound_j == 1.0
    # the pairs' neighbourhood at t = 0: apocentre against the distance
    # from the pair's centre of mass to the nearest other star
    mi, mj = torch.from_numpy(m[i])[:, None], torch.from_numpy(m[j])[:, None]
    com = (ts.pos[ti] * mi + ts.pos[tj] * mj) / (mi + mj)
    d = torch.cdist(com, ts.pos)
    rows = torch.arange(len(i))
    d[rows, ti] = np.inf
    d[rows, tj] = np.inf
    near = d.min(dim=1).values.numpy()
    apo = ja * (1.0 + je)
    assert 0.10 < float(np.mean(apo > near)) < 0.16
    assert 0.20 < float(np.mean(apo > 0.5 * near)) < 0.32
