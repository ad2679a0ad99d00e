"""The benchmark's CPU tests: ``pytest bench_torch/tests`` from the root."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import dataclasses  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

# The drift classes hold at the deployments' N; a stand-in of 512 to 2,048
# stars under the same fixed dt reads up to ~4e-6 from its close pairs. A
# stand-in whose sound runs and faults this does not separate (an adaptive
# step reads far less) states its own ``drift`` in its ``[stand_in]``.
STAND_IN_DRIFT = 1e-4


def stand_in(name, root=ROOT):
    """The cell ``name`` of the checkout ``root`` at its stand-in's segment
    (its workload file's ``[stand_in]``), with the stand-in's drift
    limit."""
    from bench_torch import harness
    cell = harness.load_cell(name, harness.load_benchmark(root), root)
    limits = dict(cell.limits,
                  drift=cell.stand_in.get("drift", STAND_IN_DRIFT))
    return dataclasses.replace(cell, segment=cell.stand_in["segment"],
                               limits=limits)


def mesh_of(cell):
    """A cell across cards runs its shards on the one CPU."""
    from oc_nbody_tpu_torch.parallel.mesh import Mesh
    return Mesh.on_one_device(cell.chips, "cpu") if cell.chips > 1 else None


@pytest.fixture
def run_cpu():
    """Run a cell on the CPU at its stand-in's size through the harness;
    returns the result object."""
    from bench_torch import harness

    def go(name, seed=7, seconds=0.05, traced=False, root=ROOT,
           out=lambda *a, **k: None):
        cell = stand_in(name, root)
        return harness.run(cell, seed, seconds, traced, time.perf_counter(),
                           device="cpu", n=cell.stand_in["n"],
                           mesh=mesh_of(cell), out=out)
    return go
