"""The port's sharded force (``oc_nbody_tpu_torch/parallel/``) against the
JAX package's ``ShardedForce`` on identical inputs, on the CPU.

The JAX side runs as its own tests run it (tests/distributed): a
``make_sharded_force(mesh=make_mesh(d), backend="jnp")`` over the 8
emulated CPU devices that tests/conftest.py sets up, each method under
``jax.jit``. The port runs d shards on the one CPU
(``Mesh.on_one_device(d, "cpu")``), every kernel through its plain twin.
Modes ``allgather``, ``ring`` and ``halfring`` x accel / accel_potential /
accel_jerk at d = 1, 2, 4, 8 and, for halfring's odd branch, d = 3; the
``rdma`` mode (the Pallas ring in interpret mode) is in
tests/test_torch_ring.py. The cluster sits on c5_131k_sharded's circular 8
kpc orbit in its Milky Way, with ragged N (120, 104, 112 for the three
methods: padding to 8 d rows). Tolerances are the JAX package's
tests/distributed/test_rdma_ring.py: accel 5e-6 of max|a_pair|, jerk 5e-5
of max|j_pair|, phi rtol 3e-5, against JAX's output and against the f64
oracle (the f64 pair sum plus the f64 field); the field's phi_ext to 1e-12.
Each mode's ``self_phi`` contract (added outside the shards except under
halfring, whose diagonal potential comes self-corrected) is what lets
every mode's phi match.
"""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

import oc_nbody_tpu.ops.pallas_ring as pr
from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.parallel import make_mesh as j_make_mesh
from oc_nbody_tpu.parallel import make_sharded_force as j_make_sharded_force
from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import scene as tscene
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import gravity as tgravity
from oc_nbody_tpu_torch.parallel.force import make_sharded_force
from oc_nbody_tpu_torch.parallel.mesh import Mesh
from test_torch_slice import REPO

C5 = os.path.join(REPO, "configs", "c5_131k_sharded.toml")
EPS = 0.05
N = {"accel": 120, "phi": 104, "jerk": 112}
TOL_A, TOL_J, TOL_PHI = 5e-6, 5e-5, 3e-5
CASES = [(mode, d) for mode in ("allgather", "ring", "halfring")
         for d in (1, 2, 4, 8)] + [("halfring", 3)]


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def inputs(n, seed=3):
    """A cluster of n on c5's orbit (8 kpc = 800 code lengths out, moving
    along it), numpy from a seed: (pos, vel, mass f32)."""
    rng = np.random.default_rng(seed + n)
    pos = rng.normal(size=(n, 3)) + np.array([800.0, 0.0, 0.0])
    vel = 0.3 * rng.normal(size=(n, 3)) + np.array([0.0, 46.0, 0.0])
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    return pos, vel, mass


def externals():
    """c5's Milky Way in each package: (JAX potential, port potential, G)."""
    jcfg = jconfig.load_config(C5)
    tcfg = tconfig.load_config(C5)
    jus, tus = jscene.build_units(jcfg), tscene.build_units(tcfg)
    return (jscene.build_external_potential(jcfg, jus),
            tscene.build_external_potential(tcfg, tus), tus.G)


@contextlib.contextmanager
def pallas_interpret():
    """The Pallas ring in interpret mode, its jit caches cleared on entry
    and exit (tests/distributed/test_rdma_ring.py's fixture)."""
    jitted = (pr.accel_ring, pr.accel_potential_ring, pr.accel_jerk_ring)
    old = os.environ.get("OCN_PALLAS_INTERPRET")
    os.environ["OCN_PALLAS_INTERPRET"] = "1"
    for fn in jitted:
        fn.clear_cache()
    try:
        yield
    finally:
        for fn in jitted:
            fn.clear_cache()
        if old is None:
            del os.environ["OCN_PALLAS_INTERPRET"]
        else:
            os.environ["OCN_PALLAS_INTERPRET"] = old


def jax_eval(mode, d, want):
    """The JAX package's sharded evaluation, numpy out: (acc,), (acc,
    phi, phi_ext) or (acc, jerk)."""
    j_ext, _, G = externals()
    pos, vel, mass = inputs(N[want])
    backend = "pallas" if mode == "rdma" else "jnp"
    with pallas_interpret() if mode == "rdma" else contextlib.nullcontext():
        sf = j_make_sharded_force(eps=EPS, G=G, external=j_ext,
                                  mesh=j_make_mesh(d), mode=mode,
                                  backend=backend)
        if want == "jerk":
            out = jax.jit(sf.accel_jerk)(pos, vel, mass)
        elif want == "phi":
            out = jax.jit(sf.accel_potential)(pos, mass)
        else:
            out = (jax.jit(sf.accel)(pos, mass),)
        return tuple(np.asarray(o, np.float64) for o in out)


def port_eval(mode, d, want, sf=None):
    """The port's sharded evaluation on d CPU shards, numpy out."""
    _, t_ext, G = externals()
    pos, vel, mass = (torch.from_numpy(a) for a in inputs(N[want]))
    if sf is None:
        sf = make_sharded_force(EPS, G, t_ext, mesh=Mesh.on_one_device(
            d, "cpu"), mode=mode)
    if want == "jerk":
        out = sf.accel_jerk(pos, vel, mass)
    elif want == "phi":
        out = sf.accel_potential(pos, mass)
    else:
        out = (sf.accel(pos, mass),)
    return tuple(o.numpy().astype(np.float64) for o in out)


def oracle(want):
    """The f64 pair sums plus the f64 field: (outputs, max|a_pair|,
    max|j_pair| or None)."""
    _, t_ext, G = externals()
    pos, vel, mass = (torch.from_numpy(a) for a in inputs(N[want]))
    m64 = mass.to(torch.float64)
    if want == "jerk":
        a, j = tgravity.accel_jerk_direct(pos, vel, m64, EPS, G)
        a_ext, j_ext = t_ext.accel_jerk_ext(pos, vel)
        return ((a + a_ext).numpy(), (j + j_ext).numpy()), \
            float(a.abs().max()), float(j.abs().max())
    if want == "phi":
        a, p = tgravity.accel_potential_direct(pos, m64, EPS, G)
        return ((a + t_ext.accel(pos)).numpy(), p.numpy(),
                t_ext.phi(pos).numpy()), float(a.abs().max()), None
    a = tgravity.accel_direct(pos, m64, EPS, G)
    return ((a + t_ext.accel(pos)).numpy(),), float(a.abs().max()), None


def check(got, want_out, want, a_scale, j_scale, what):
    np.testing.assert_allclose(got[0], want_out[0], rtol=0,
                               atol=TOL_A * a_scale, err_msg=f"{what} accel")
    if want == "jerk":
        np.testing.assert_allclose(got[1], want_out[1], rtol=0,
                                   atol=TOL_J * j_scale,
                                   err_msg=f"{what} jerk")
    if want == "phi":
        np.testing.assert_allclose(got[1], want_out[1], rtol=TOL_PHI,
                                   err_msg=f"{what} phi")
        np.testing.assert_allclose(got[2], want_out[2], rtol=1e-12,
                                   err_msg=f"{what} phi_ext")


@pytest.fixture(scope="module")
def jax_out():
    """The JAX evaluations, each computed once for the module."""
    cache = {}

    def get(mode, d, want):
        if (mode, d, want) not in cache:
            cache[mode, d, want] = jax_eval(mode, d, want)
        return cache[mode, d, want]
    return get


@pytest.mark.parametrize("want", ("accel", "phi", "jerk"))
@pytest.mark.parametrize("mode,d", CASES)
def test_sharded_force_matches_jax_and_the_f64_oracle(mode, d, want,
                                                      jax_out):
    got = port_eval(mode, d, want)
    ref, a_scale, j_scale = oracle(want)
    check(got, jax_out(mode, d, want), want, a_scale, j_scale,
          f"{mode} d={d} against JAX")
    check(got, ref, want, a_scale, j_scale, f"{mode} d={d} against f64")


@pytest.mark.parametrize("mode", ("allgather", "ring", "rdma", "halfring"))
def test_every_mode_is_bitwise_repeatable(mode):
    _, t_ext, G = externals()
    sf = make_sharded_force(EPS, G, t_ext, mesh=Mesh.on_one_device(4, "cpu"),
                            mode=mode)
    for want in ("accel", "phi", "jerk"):
        first, second = port_eval(mode, 4, want, sf), port_eval(mode, 4,
                                                                want, sf)
        for a, b in zip(first, second):
            assert np.array_equal(a, b), (mode, want)


@pytest.mark.parametrize("d", (2, 4, 8))
def test_rdma_twins_equal_the_ring_mode_bitwise(d):
    """On the CPU the ``rdma`` mode (K20/K21's twins: the slab's pair sum,
    then the store or Kahan step) and the ``ring`` mode (a rows sum per hop,
    then ``_two_sum``) do the same arithmetic in the same order: the same
    slab order s, s-1, ..., the same G m, the same Kahan step."""
    for want in ("accel", "phi", "jerk"):
        for a, b in zip(port_eval("rdma", d, want),
                        port_eval("ring", d, want)):
            assert np.array_equal(a, b), (d, want)


@pytest.mark.parametrize("d", (2, 3, 8))
def test_halfring_conserves_momentum(d):
    """Sum m a = 0 (tests/distributed/test_halfring.py): the reactions
    reach their owners, each pair once."""
    pos, _, mass = (torch.from_numpy(a) for a in inputs(120, seed=11))
    sf = make_sharded_force(EPS, 1.0, mesh=Mesh.on_one_device(d, "cpu"),
                            mode="halfring")
    acc = sf.accel(pos, mass)
    m = mass.to(torch.float64)[:, None]
    ptot = (m * acc).sum(dim=0)
    assert float(ptot.abs().max()) < 1e-6 * float((m * acc.abs()).sum())


def test_shards_pad_with_zero_mass_and_land_on_the_state_device():
    """120 rows on 8 shards pad to 128 (16 a shard); the outputs are the
    120 rows, in the state's dtype, and each mode's launches are counted
    per shard: d per shard under ring and rdma, one under allgather."""
    pos, vel, mass = (torch.from_numpy(a) for a in inputs(120))
    for mode, calls in (("allgather", {"rows": 8}),
                        ("ring", {"rows": 64}), ("rdma", {"ring": 64})):
        sf = make_sharded_force(EPS, 1.0, mesh=Mesh.on_one_device(8, "cpu"),
                                mode=mode)
        before = dict(cg.PLAIN_CALLS)
        acc = sf.accel(pos, mass)
        ran = {k: cg.PLAIN_CALLS[k] - before[k] for k in before
               if cg.PLAIN_CALLS[k] != before[k]}
        assert ran == calls, mode
        assert acc.shape == (120, 3) and acc.dtype == torch.float64
        assert acc.device == pos.device
