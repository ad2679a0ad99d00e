"""The control (the reference in bfloat16 in the program's place) fails each
cell's limits, and the program's readings pass them, at a test size."""
import pytest

from bench_torch import check
from bench_torch.readings import segment_readings
from conftest import mesh_of, stand_in
from tests_cells import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    cell = stand_in(name)
    r = segment_readings(cell, 11, device="cpu", n=cell.stand_in["n"],
                         mesh=mesh_of(cell))
    ok, _ = check.judge(r["program"], cell.limits)
    assert ok, r["program"]
    bad, rows = check.judge(r["control"], cell.limits)
    assert not bad, r["control"]
