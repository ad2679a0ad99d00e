"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half the sources left out with the
rest weighted double, the exchange between shards left out, an answer
altered where it is produced, and an integrator that lost its order
(``faults.py``). The sound run beside them is correct."""
import pytest
import torch

from bench_torch import faults
from oc_nbody_tpu_torch import diagnostics
from oc_nbody_tpu_torch.integrators.block import BlockHermite
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.parallel.force import ShardedForce
from tests_cells import CELLS


def _frozen_kdk(monkeypatch):
    step = LeapfrogKDK.step

    def frozen(self, carry):
        new = step(self, carry)
        return new.replace(state=carry.state.replace(time=new.state.time),
                           acc=carry.acc)
    monkeypatch.setattr(LeapfrogKDK, "step", frozen)


def _frozen_block(monkeypatch):
    micro = BlockHermite._micro_step

    def frozen(self, carry, *a, **kw):
        new = micro(self, carry, *a, **kw)
        if new is None:
            return None
        return new.replace(state=new.state.replace(pos=carry.state.pos,
                                                   vel=carry.state.vel))
    monkeypatch.setattr(BlockHermite, "_micro_step", frozen)


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
    for cell in CELLS:
        for fault in FAULTS:
            if fault == "no_exchange" and not cell.startswith("c5"):
                continue       # only a cell across cards has an exchange
            yield pytest.param(cell, fault, id=f"{cell}-{fault}")


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_fault_makes_the_run_incorrect(run_cpu, monkeypatch, cell, fault):
    if fault == "unchanged_state":
        (_frozen_block if cell.startswith("c4") else _frozen_kdk)(monkeypatch)
    elif fault == "first_order":
        faults.plant("block" if cell.startswith("c4") else "kdk",
                     monkeypatch.setattr)
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
