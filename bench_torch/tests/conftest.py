"""The benchmark's CPU tests: ``pytest bench_torch/tests`` from the root."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import dataclasses  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

# small stand-ins of each cell on the CPU: (stars, segment)
TINY = {"north_star_65k.orbit": (512, 1 / 32),
        "c4_block_32k.orbit": (512, 1 / 32),
        "c5_131k_sharded.ring4": (2048, 1 / 64)}
# The drift classes hold at the deployments' N; a stand-in of 512 to 2,048
# stars under the same fixed dt reads up to ~4e-6 from its close pairs.
STAND_IN_DRIFT = 1e-4


def stand_in(name):
    """The cell ``name`` at its stand-in's segment, with the stand-in's
    drift limit."""
    from bench_torch import harness
    cell = harness.load_cell(name, harness.load_benchmark())
    limits = dict(cell.limits, drift=STAND_IN_DRIFT)
    return dataclasses.replace(cell, segment=TINY[name][1], limits=limits)


@pytest.fixture
def run_cpu():
    """Run a cell of BENCHMARK.json on the CPU at its tiny size through the
    harness; returns the result object."""
    from bench_torch import harness
    from oc_nbody_tpu_torch.parallel.mesh import Mesh

    def go(name, seed=7, seconds=0.05, traced=False):
        cell = stand_in(name)
        n = TINY[name][0]
        mesh = (Mesh.on_one_device(cell.chips, "cpu") if cell.chips > 1
                else None)
        return harness.run(cell, seed, seconds, traced, time.perf_counter(),
                           device="cpu", n=n, mesh=mesh,
                           out=lambda *a, **k: None)
    return go
