"""A replayed segment ends in the same bits, through each stepper, and the
harness runs each cell's path end to end on the CPU."""
import pytest
import torch

from bench_torch import harness
from oc_nbody_tpu_torch.integrators.block import BlockHermite
from oc_nbody_tpu_torch.integrators.hermite import Hermite4
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.scene import build_scene
from tests_cells import CELLS


def _scene(n=256):
    cell = harness.load_cell("north_star_65k.orbit",
                             harness.load_benchmark())
    return build_scene(harness.sim_config(cell, 5, n), "cpu")


@pytest.mark.parametrize("make", [
    lambda f: LeapfrogKDK(force=f, dt=1 / 1024),
    lambda f: Hermite4(force=f, eta=0.02, eta_init=0.01, dt_max=1 / 64),
    lambda f: BlockHermite(force=f, eta=0.02, eta_init=0.01, dt_max=1 / 64,
                           n_levels=8)], ids=["kdk", "hermite", "block"])
def test_segment_replays_bitwise(make):
    scene = _scene()
    stepper = make(scene.force)
    carry0 = stepper.init(scene.state)
    saved = [t.clone() for t in (carry0.state.pos, carry0.state.vel,
                                 carry0.acc)]
    t_end = scene.state.time + 1 / 32
    a = stepper.advance_to(carry0, t_end)
    b = stepper.advance_to(carry0, t_end)
    assert a.n_steps == b.n_steps > 0
    for x, y in ((a.state.pos, b.state.pos), (a.state.vel, b.state.vel),
                 (a.acc, b.acc)):
        assert torch.equal(x, y)
    for x, y in zip(saved, (carry0.state.pos, carry0.state.vel, carry0.acc)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_and_repeats(run_cpu, name):
    r = run_cpu(name, seconds=0.2)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["compared"]["segments_differ"]["value"] == 0
    cell = harness.load_cell(name, harness.load_benchmark())
    assert set(r["metrics"]) == set(cell.end_to_end)
    assert {m.split(".")[0] for m in r["metrics"]} == {
        "sim_myr_per_s", "step_ms_p95", "setup_s"}
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_finds_no_device_and_reads_host_metrics(run_cpu, name):
    r = run_cpu(name, traced=True)
    assert r["correct"], r["compared"]
    # a fenced segment and a profiled one, both from the saved carry
    assert r["attempted"] == 2
    assert r["compared"]["segments_differ"]["value"] == 0
    # no card: device readers find nothing and leave their metric out
    assert {m.split(".")[0] for m in r["metrics"]} == {"scene",
                                                        "diagnostics"}
    assert "busy_s" not in r["device"]
