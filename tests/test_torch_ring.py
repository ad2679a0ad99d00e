"""The sharded ring (``ops/cuda_ring.py``: the schedule and the plain twins
of K20 and K21) against the JAX package's Pallas ring, on the CPU.

``ShardedForce(mode="rdma")`` is held to the JAX package's
``make_sharded_force(mode="rdma", backend="pallas")``, run as
tests/distributed/test_rdma_ring.py runs it: the Pallas ring kernels #23-25
(pallas_ring.py:135, :169, :202) in interpret mode with their jit caches
cleared, on d of the 8 emulated CPU devices, d = 1, 2, 4, 8, x accel /
accel_potential / accel_jerk, with the inputs and tolerances of
tests/test_torch_sharded.py. Then the port's own contracts: the twins
store at the first ring step and add by a Kahan step after it, which
beats a plain running sum against the f64 oracle across 8 shards (the
counterpart of tests/distributed/test_ring_compensation.py, degrading the
step by monkeypatch); shard s meets the slabs of shards s, s - 1, ...,
s - d + 1 in that order; d = 1 is one launch from the shard's own planes
with no slab; the slabs and sums are allocated once and reused. The
kernels themselves are held to these twins on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import cuda_ring
from oc_nbody_tpu_torch.ops import gravity as tgravity
from oc_nbody_tpu_torch.parallel.force import make_sharded_force
from oc_nbody_tpu_torch.parallel.mesh import Mesh
from test_torch_sharded import (check, jax_eval, oracle, port_eval)


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("want", ("accel", "phi", "jerk"))
@pytest.mark.parametrize("d", (1, 2, 4, 8))
def test_rdma_matches_the_pallas_ring_and_the_f64_oracle(d, want):
    got = port_eval("rdma", d, want)
    ref, a_scale, j_scale = oracle(want)
    check(got, jax_eval("rdma", d, want), want, a_scale, j_scale,
          f"rdma d={d} against the Pallas ring")
    check(got, ref, want, a_scale, j_scale, f"rdma d={d} against f64")


def _shards(n, d, seed, vel=False):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(size=(n, 3))).to(torch.float32)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(torch.float32)
    v = torch.from_numpy(0.3 * rng.normal(size=(n, 3))).to(torch.float32)
    size = n // d
    cut = [slice(s * size, (s + 1) * size) for s in range(d)]
    out = ([pos[c] for c in cut], [mass[c] for c in cut])
    if vel:
        out = out + ([v[c] for c in cut],)
    return (pos, mass, v), out


def test_ring_step_twin_stores_then_kahan_adds():
    """First step: the step's sum stored, the compensation zeroed. Later
    steps: (sum - comp) grows by the step's sum, the pair sum within
    5e-6 of the f64 step and the compensation holding what the rounded sum
    dropped."""
    (pos, mass, vel), _ = _shards(256, 1, 5)
    rows, src, gm = pos[:96], pos[96:], mass[96:] * 1.25
    rng = np.random.default_rng(6)
    acc = torch.from_numpy(rng.normal(size=(96, 3))).to(torch.float32)
    comp = torch.from_numpy(1e-8 * rng.normal(size=(96, 3))).to(
        torch.float32)
    phi = torch.from_numpy(rng.normal(size=96)).to(torch.float32)
    pcomp = torch.from_numpy(1e-8 * rng.normal(size=96)).to(torch.float32)
    before = [t.double() for t in (acc, comp, phi, pcomp)]
    a64, p64 = tgravity.accel_potential_rows(rows.double(), src.double(),
                                             gm.double(), 0.05, 1.0)
    cuda_ring.ring_step_plain(rows, src, gm, 0.05, acc, comp, phi, pcomp,
                              first=False)
    for new, c, (old, oldc), step in (
            (acc, comp, before[:2], a64), (phi, pcomp, before[2:], p64)):
        grown = (new.double() - c.double()) - (old - oldc)
        scale = float(step.abs().max())
        assert float((grown - step).abs().max()) < 5e-6 * scale
    cuda_ring.ring_step_plain(rows, src, gm, 0.05, acc, comp, phi, pcomp,
                              first=True)
    assert float(comp.abs().max()) == 0.0 and float(pcomp.abs().max()) == 0.0
    assert torch.equal(acc, tgravity.accel_rows(rows, src, gm, 0.05, 1.0))
    # the jerk twin: the same store, then the same Kahan identity
    acc2, jerk = torch.zeros(96, 3), torch.zeros(96, 3)
    ca, cj = torch.ones(96, 3), torch.ones(96, 3)
    cuda_ring.ring_step_jerk_plain(rows, vel[:96], src, vel[96:], gm, 0.05,
                                   acc2, jerk, ca, cj, first=True)
    a_ref, j_ref = tgravity.accel_jerk_rows(rows, vel[:96], src, vel[96:],
                                            gm, 0.05, 1.0)
    assert torch.equal(acc2, a_ref) and torch.equal(jerk, j_ref)
    assert float(ca.abs().max()) == 0.0 and float(cj.abs().max()) == 0.0


def test_ring_compensation_beats_a_plain_running_sum(monkeypatch):
    """Across 8 shards the Kahan step recovers the rounding of the 8 f32
    additions: with it the ring tracks the f64 oracle strictly better on
    average, and never meaningfully worse, than with the step degraded to
    plain summation (tests/distributed/test_ring_compensation.py)."""
    n, d = 4096, 8
    (pos, mass, _), (ps, ms) = _shards(n, d, 17)
    ref = tgravity.accel_rows(pos.double(), pos.double(), mass.double(),
                              0.05, 1.0).numpy()
    a_comp = torch.cat(cuda_ring.accel_ring(ps, ms, 0.05)).double().numpy()

    def plain(out, comp, part, first):
        if first:
            out.copy_(part)
        else:
            out.add_(part)

    monkeypatch.setattr(cuda_ring, "_accumulate", plain)
    a_plain = torch.cat(cuda_ring.accel_ring(ps, ms, 0.05)).double().numpy()
    err_comp, err_plain = np.abs(a_comp - ref), np.abs(a_plain - ref)
    assert err_comp.mean() < err_plain.mean(), (err_comp.mean(),
                                                err_plain.mean())
    assert err_comp.max() <= err_plain.max() + 1e-7 * np.abs(ref).max()


@pytest.mark.parametrize("d", (2, 3, 4))
def test_each_shard_meets_the_slabs_in_the_jax_order(monkeypatch, d):
    """The i-th step launch is shard s = i % d at ring step k = i // d, and
    it sweeps the slab of shard (s - k) mod d: the JAX ring's order."""
    _, (ps, ms, vs) = _shards(48 * d, d, 9, vel=True)
    seen = []
    real = cuda_ring.ring_step_jerk

    def spy(rows, vrows, src, *args, **kw):
        seen.append(src.clone())
        return real(rows, vrows, src, *args, **kw)

    monkeypatch.setattr(cuda_ring, "ring_step_jerk", spy)
    cuda_ring.accel_jerk_ring(ps, vs, ms, 0.05)
    assert len(seen) == d * d
    for i, src in enumerate(seen):
        k, s = divmod(i, d)
        assert torch.equal(src, ps[(s - k) % d]), (k, s)


def test_one_shard_is_one_launch_without_a_slab():
    _, (ps, ms) = _shards(64, 1, 4)
    before = dict(cg.PLAIN_CALLS)
    buffers = cuda_ring.RingBuffers()
    (acc, phi), = cuda_ring.accel_potential_ring(ps, ms, 0.05,
                                                 buffers=buffers)
    assert cg.PLAIN_CALLS["ring_phi"] - before["ring_phi"] == 1
    assert not buffers.rings
    a_ref, p_ref = tgravity.accel_potential_rows(ps[0], ps[0], ms[0], 0.05,
                                                 1.0)
    assert torch.equal(acc, a_ref) and torch.equal(phi, p_ref)


def test_ring_buffers_are_allocated_once_and_results_are_copies():
    """A caller's RingBuffers keeps one ring per kind: reused at the same
    devices and shard size, replaced at another; the results are copies."""
    _, (ps, ms) = _shards(256, 4, 12)
    buffers = cuda_ring.RingBuffers()
    first = cuda_ring.accel_ring(ps, ms, 0.05, buffers=buffers)
    ring = buffers.rings["ring"]
    slabs = [s.data_ptr() for s in ring.slabs]
    second = cuda_ring.accel_ring(ps, ms, 0.05, buffers=buffers)
    assert buffers.rings["ring"] is ring
    assert [s.data_ptr() for s in ring.slabs] == slabs
    for a, b, kept in zip(first, second, ring.sums):
        assert torch.equal(a, b)
        assert a.data_ptr() != kept[0].data_ptr()
    _, (ps2, ms2) = _shards(128, 4, 12)
    cuda_ring.accel_ring(ps2, ms2, 0.05, buffers=buffers)
    assert buffers.rings["ring"] is not ring and len(buffers.rings) == 1


def test_ring_step_refusals():
    _, (ps, ms) = _shards(32, 1, 2)
    acc = torch.zeros(32, 3)
    with pytest.raises(ValueError, match="acc_comp is needed"):
        cuda_ring.ring_step_kernel(ps[0], ps[0], ms[0], 0.05, acc,
                                   first=False)
    with pytest.raises(ValueError, match="same number of rows"):
        cuda_ring.accel_ring([ps[0], ps[0][:16]], [ms[0], ms[0][:16]], 0.05)
    with pytest.raises(TypeError, match="float32"):
        cuda_ring.ring_step_kernel(ps[0].double(), ps[0], ms[0], 0.05, acc,
                                   first=True)


def test_sharded_rdma_launch_counts_are_d_squared():
    pos = torch.from_numpy(np.random.default_rng(1).normal(size=(200, 3)))
    mass = torch.full((200,), 1.0 / 200, dtype=torch.float32)
    vel = 0.1 * pos
    for d in (1, 3, 5):
        sf = make_sharded_force(0.05, mesh=Mesh.on_one_device(d, "cpu"),
                                mode="rdma")
        before = dict(cg.PLAIN_CALLS)
        sf.accel(pos, mass)
        sf.accel_potential(pos, mass)
        sf.accel_jerk(pos, vel, mass)
        ran = {k: cg.PLAIN_CALLS[k] - before[k] for k in before
               if cg.PLAIN_CALLS[k] != before[k]}
        assert ran == {"ring": d * d, "ring_phi": d * d,
                       "ring_jerk": d * d}, d
