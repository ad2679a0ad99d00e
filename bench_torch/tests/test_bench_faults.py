"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half the sources left out with the
rest weighted double, the exchange between shards left out, an answer
altered where it is produced, and an integrator that lost its order
(``faults.py``, by ``kinds.KINDS``). The sound run beside them is correct. The step faults are
the cell's stepper kind's; the exchange is left out where the cell has
cards to exchange between."""
import pytest
import torch

from bench_torch import kinds
from oc_nbody_tpu_torch import diagnostics
from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.parallel.force import ShardedForce
from conftest import stand_in
from tests_cells import CELLS


def _half_sources(monkeypatch):
    """Every other source, its mass doubled: the mean over half."""
    for name in ("accel_rows", "accel_potential_rows"):
        fn = getattr(gravity, name)

        def half(rows, src, mass, *a, _fn=fn, **kw):
            return _fn(rows, src[::2], 2 * mass[::2], *a, **kw)
        monkeypatch.setattr(gravity, name, half)
    jerk = gravity.accel_jerk_rows

    def half_jerk(rows, vrows, src, svel, mass, *a, **kw):
        return jerk(rows, vrows, src[::2], svel[::2], 2 * mass[::2], *a,
                    **kw)
    monkeypatch.setattr(gravity, "accel_jerk_rows", half_jerk)


def _no_exchange(monkeypatch):
    """Each shard against its own sources only: the ring never turns."""
    def local(self, want, shards):
        return [self._rows(want, sh, sh, dev)
                for sh, dev in zip(shards, self.mesh.devices)]
    monkeypatch.setattr(ShardedForce, "_ring", local)


def _altered_row(monkeypatch):
    compute_all = diagnostics.compute_all

    def altered(*a, **kw):
        row = compute_all(*a, **kw)
        row["E_int"] = row["E_int"] * (1 + 1e-3)
        return row
    monkeypatch.setattr(diagnostics, "compute_all", altered)


FAULTS = {"unchanged_state": None, "half_sources": _half_sources,
          "altered_answer": _altered_row, "no_exchange": _no_exchange,
          "first_order": None}


def _cases():
    for name in CELLS:
        cell = stand_in(name)
        for fault in FAULTS:
            if fault == "no_exchange" and cell.chips == 1:
                continue       # only a cell across cards has an exchange
            yield pytest.param(name, fault, id=f"{name}-{fault}")


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_fault_makes_the_run_incorrect(run_cpu, monkeypatch, cell, fault):
    kind = kinds.of(stand_in(cell).sim["integrator"]["kind"])
    if fault == "unchanged_state":
        kind.frozen(monkeypatch.setattr)
    elif fault == "first_order":
        kind.fault(monkeypatch.setattr)
    else:
        FAULTS[fault](monkeypatch)
    r = run_cpu(cell)
    assert not r["correct"]
    assert r["failed"] == r["attempted"]
    over = [k for k, v in r["compared"].items() if v["value"] > v["limit"]]
    assert over, r["compared"]


def test_a_plain_twin_on_the_card_is_counted(monkeypatch):
    """The count the harness reads moves when a twin runs."""
    from oc_nbody_tpu_torch.ops import cuda_gravity
    before = sum(cuda_gravity.PLAIN_CALLS.values())
    x = torch.zeros((4, 3))
    cuda_gravity.rows_plain(x, x, torch.ones(4), 0.1)
    assert sum(cuda_gravity.PLAIN_CALLS.values()) == before + 1
