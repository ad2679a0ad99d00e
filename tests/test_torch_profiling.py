"""The port's spans (``oc_nbody_tpu_torch.utils.profiling``) on the CPU:
off without a profiler, recorded under one, and where the program opens
them: one read per block micro-step, the ring's bytes per step, the row's
parts, the Stopwatch's phases."""
import collections
import os
import time

import pytest
import torch

from oc_nbody_tpu_torch import config as tconfig
from oc_nbody_tpu_torch import diagnostics
from oc_nbody_tpu_torch import run as trun
from oc_nbody_tpu_torch.parallel.mesh import Mesh
from oc_nbody_tpu_torch.scene import build_scene, make_stepper
from oc_nbody_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C1 = os.path.join(REPO, "configs", "c1_plummer_1k.toml")
C3 = os.path.join(REPO, "configs", "c3_hermite_16k_kroupa.toml")
C4 = os.path.join(REPO, "configs", "c4_block_32k_eccentric.toml")
C5 = os.path.join(REPO, "configs", "c5_131k_sharded.toml")


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _recorded(fn):
    """Run ``fn`` under a CPU profiler; the spans it recorded."""
    t0 = profiling.clock_ns()
    with _profiler():
        fn()
    return [r for r in profiling.spans() if r.start_ns >= t0]


def _cfg(path, *overrides):
    return tconfig.apply_overrides(tconfig.load_config(path), [
        "output.stdout=false", *overrides])


def test_span_is_the_shared_no_op_without_a_profiler():
    n = len(profiling.spans())
    s = profiling.span("integrator.step")
    assert s is profiling.span("parallel.exchange", moves=torch.zeros(3),
                               site="x")
    with s, profiling.span("diagnostics.core", device=torch.device("cpu")):
        pass
    assert len(profiling.spans()) == n


def test_nested_spans_record_parents_attributes_and_times():
    moved = [torch.zeros(4), (torch.zeros(2, 3, dtype=torch.float64),)]

    def work():
        with profiling.span("outer"):
            with profiling.span("inner", moves=moved, site="here"):
                time.sleep(0.001)
            with profiling.span("second"):
                pass

    recs = {r.name: r for r in _recorded(work)}
    outer, inner, second = recs["outer"], recs["inner"], recs["second"]
    assert outer.parent is None
    assert inner.parent == outer.id and second.parent == outer.id
    assert inner.bytes == 4 * 4 + 6 * 8 and inner.site == "here"
    assert outer.bytes is None and inner.device_ms is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns
    assert inner.end_ns - inner.start_ns >= 1_000_000
    assert inner.end_ns <= second.start_ns <= second.end_ns <= outer.end_ns


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))

    def work():
        for i in range(20):
            with profiling.span(f"s{i}"):
                pass

    recs = _recorded(work)
    assert [r.name for r in recs] == [f"s{i}" for i in range(12, 20)]


def test_block_steps_read_once_per_micro_step():
    cfg = _cfg(C4, "ic.n=256")
    scene = build_scene(cfg, "cpu")
    stepper, kind = make_stepper(cfg, scene.force)
    assert kind == "block"
    carry = stepper.init(scene.state)
    end = carry.state.time + 2 * float(cfg.integrator.dt_max)
    out = {}
    recs = _recorded(lambda: out.update(c=stepper.advance_to(carry, end)))
    steps = [r for r in recs if r.name == "integrator.step"]
    waits = [r for r in recs if r.name == "integrator.wait"]
    # advance_to's last read finds t_next past the end: one step span more
    assert len(steps) == out["c"].n_steps - carry.n_steps + 1 > 2
    assert len(waits) == len(steps)
    step_ids = {r.id for r in steps}
    assert all(w.parent in step_ids and w.site == "block.schedule"
               for w in waits)


def test_hermite_reads_once_per_step_and_kdk_never():
    cfg = _cfg(C3, "ic.n=128")
    scene = build_scene(cfg, "cpu")
    stepper, kind = make_stepper(cfg, scene.force)
    assert kind == "hermite"
    carry = stepper.init(scene.state)
    recs = _recorded(lambda: stepper.advance(carry, 3))
    names = collections.Counter(r.name for r in recs)
    evals = 2 if stepper.symmetrized else 1
    assert names["integrator.step"] == 3
    assert names["integrator.wait"] == 3 * evals
    cfg = _cfg(C1, "ic.n=128")
    scene = build_scene(cfg, "cpu")
    stepper, kind = make_stepper(cfg, scene.force)
    carry = stepper.init(scene.state)
    recs = _recorded(lambda: stepper.advance(carry, 3))
    names = collections.Counter(r.name for r in recs)
    assert kind == "kdk" and names["integrator.step"] == 3
    assert names["integrator.wait"] == 0


D = 4
N = 500


def _ring_bytes(mode: str) -> int:
    """Bytes handed between shards in one KDK force evaluation at N on D
    shards: positions (f32, 3) and masses (f32) are 16 bytes a padded row,
    an accel output 12."""
    n_pad = -(-N // (8 * D)) * 8 * D
    split, gather = 16 * n_pad, 12 * n_pad
    per_mode = {
        # D - 1 hops, each hands on every shard's positions and masses
        "ring": (D - 1) * 16 * n_pad,
        # the same slabs (positions and G m), one copy a shard a ring step
        "rdma": (D - 1) * 16 * n_pad,
        # the planes once to the one card of the mesh
        "allgather": 16 * n_pad,
        # at even D: a visit per shard at hop 1 and at hop D/2, and the
        # reactions returned from each
        "halfring": 2 * 16 * n_pad + 2 * 12 * n_pad,
    }
    return split + per_mode[mode] + gather


@pytest.mark.parametrize("mode", ("ring", "rdma", "allgather", "halfring"))
def test_sharded_exchange_bytes_follow_the_ring_arithmetic(mode):
    cfg = _cfg(C5, f"ic.n={N}", f"mesh.mode={mode}")
    scene = build_scene(cfg, "cpu", mesh=Mesh.on_one_device(D, "cpu"))
    stepper, kind = make_stepper(cfg, scene.force)
    carry = stepper.init(scene.state)
    recs = _recorded(lambda: stepper.advance(carry, 2))
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "integrator.step"]
    assert kind == "kdk" and len(steps) == 2
    for step in steps:
        moved = 0
        for r in recs:
            p = by_id.get(r.parent)
            while p is not None and p.id != step.id:
                p = by_id.get(p.parent)
            if r.name == "parallel.exchange" and p is not None:
                moved += r.bytes
        assert moved == _ring_bytes(mode)


@pytest.mark.parametrize("config,f64_pairwise", (
    ("c1_plummer_1k", False), ("c1_plummer_1k", True),
    ("north_star_65k_orbit", False)))
def test_the_row_holds_its_pair_potential_and_core(config, f64_pairwise):
    cfg = _cfg(os.path.join(REPO, "configs", f"{config}.toml"), "ic.n=128")
    scene = build_scene(cfg, "cpu")
    recs = _recorded(lambda: diagnostics.compute_all(
        scene.state, scene.force, f64_pairwise=f64_pairwise, core=True))
    row = [r for r in recs if r.name == "diagnostics.row"]
    assert len(row) == 1
    parts = {r.name: r for r in recs if r.parent == row[0].id
             and r.name != "diagnostics.wait"}
    assert set(parts) == {"diagnostics.pair_phi", "diagnostics.core"}
    assert all(p.device_ms is None for p in parts.values())   # the CPU
    # the row's syncs, each a wait span with its site
    waits = {r.site: r.parent for r in recs if r.name == "diagnostics.wait"}
    want = {"lagrangian_radii.fractions": row[0].id,
            "local_density.inf": parts["diagnostics.core"].id}
    if scene.force.external is not None:   # the tidal cut's eigenvalues
        want["bound_mass_tidal.eigvalsh"] = row[0].id
    assert waits == want


def test_stopwatch_phases_are_spans():
    watch = profiling.Stopwatch("cpu")

    def work():
        with watch.phase("advance"):
            pass
    recs = _recorded(work)
    assert [r.name for r in recs] == ["run.advance"]
    assert watch.counts == {"advance": 1}
    cfg = _cfg(C1, "ic.n=64", "output.t_end=0.0625",
               "output.diag_every=0.03125")
    res = {}
    recs = _recorded(lambda: res.update(r=trun.run(cfg, device="cpu")))
    names = collections.Counter(r.name for r in recs)
    assert names["run.init"] == 1
    assert names["run.advance"] == 2 and names["run.diagnostics"] == 3
    assert names["diagnostics.row"] == 3
    assert sum(1 for r in recs if r.site == "run.row") == 3
    assert names["integrator.step"] == res["r"].n_steps
    assert set(res["r"].phase_s) == {"init", "advance", "diagnostics"}


CHUNKED = [  # (dispatch function, velocities, chunk size's name, form)
    ("accel", False, "CHUNK_SYM", "sym"),
    ("accel_potential", False, "CHUNK_SYM", "sym_phi"),
    ("accel_jerk", True, "CHUNK_SYMJ", "sym_jerk"),
    ("accel_x", False, "CHUNK_SYMX", "sym_x"),
    ("accel_potential_x", False, "CHUNK_SYMX", "sym_phi_x"),
    ("accel_jerk_x", True, "CHUNK_SYMXJ", "sym_jerk_x"),
]


@pytest.mark.parametrize("fn,with_vel,chunk,form", CHUNKED)
def test_a_chunked_evaluation_spans_each_tile(monkeypatch, fn, with_vel,
                                              chunk, form):
    """Past STREAM_N (lowered to 256, chunks of 128): n = 600 is five
    chunks, the last of 88 stars; one ``force.chunked`` span holds five
    ``force.diag`` and ten ``force.cross`` spans whose pairs add up to
    n(n-1)/2, each counting the particles it reads. Without a profiler
    nothing is recorded."""
    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(cg, chunk, 128)
    n = 600
    gen = torch.Generator().manual_seed(11)
    pos = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    vel = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    mass = torch.full((n,), 1.0 / n, dtype=torch.float32)
    args = (pos, vel, mass) if with_vel else (pos, mass)
    recs = _recorded(lambda: getattr(cg, fn)(*args, 0.01))
    chunked = [r for r in recs if r.name == "force.chunked"]
    assert len(chunked) == 1
    tiles = [r for r in recs if r.name in ("force.diag", "force.cross")]
    assert all(r.parent == chunked[0].id for r in tiles)
    diag = [r for r in tiles if r.name == "force.diag"]
    cross = [r for r in tiles if r.name == "force.cross"]
    assert len(diag) == 5 and len(cross) == 10
    assert sum(r.pairs for r in tiles) == n * (n - 1) // 2
    assert [r.particles for r in diag] == [128] * 4 + [88]
    assert sorted({r.particles for r in cross}) == [216, 256]
    assert {r.form for r in tiles} == {form}
    assert all(r.device_ms is None for r in tiles + chunked)   # the CPU
    before = len(profiling.spans())
    getattr(cg, fn)(*args, 0.01)
    assert len(profiling.spans()) == before
    assert profiling.span("force.cross", device=pos.device, pairs=1,
                          form=form, particles=2) is profiling.span("x")


def test_the_million_star_layout_counts_every_pair_once():
    """c6's layout, N = 1,048,576 in chunks of CHUNK_SYM = 131,072, through
    ``_chunked_sum`` with stand-in tiles: 8 diagonal tiles and 28 chunk
    pairs whose pairs add up to N(N-1)/2, 87.5% of them in the pairs."""
    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    n, k = 1048576, cg.CHUNK_SYM

    def diag(k0, k1):
        return (torch.zeros(k1 - k0, 1),)

    def cross(i0, i1, j0, j1):
        return torch.zeros(i1 - i0, 1), torch.zeros(j1 - j0, 1)

    recs = _recorded(lambda: cg._chunked_sum(n, k, diag, cross, "sym",
                                             torch.device("cpu")))
    diag_pairs = [r.pairs for r in recs if r.name == "force.diag"]
    cross_pairs = [r.pairs for r in recs if r.name == "force.cross"]
    assert len(diag_pairs) == 8 and len(cross_pairs) == 28
    assert sum(diag_pairs) + sum(cross_pairs) == n * (n - 1) // 2 \
        == 549_755_289_600
    assert sum(cross_pairs) / (n * (n - 1) // 2) == pytest.approx(0.875,
                                                                  abs=1e-5)
