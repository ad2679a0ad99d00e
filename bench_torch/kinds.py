"""What differs between the port's stepper kinds, in one record a kind,
keyed by the kind that a configuration's ``integrator.kind`` names (as
``scene.make_stepper`` maps it). The harness, the check, the roofline
reader, ``readings.py`` and the tests read it; nothing picks by a cell's
name. A new kind is one entry here and its two faults in ``faults.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from bench_torch import faults, roofline

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Kind:
    step_method: str        # what ``advance_to`` calls a step; a step mark
                            # follows each call that returns a carry
    carry_tensors: tuple    # the carry's tensors beyond (pos, vel, acc) and
    carry_host: tuple       # host numbers beyond (time, n_steps) that a
                            # replayed segment has to end in
    warm_blocks: bool       # warm up by dt_max blocks (else by steps)
    field: bool             # the check holds it under an external field
    jerk: bool              # its carry holds a pair jerk to compare
    pair_force: Callable    # (end carry, reference field) -> (pair accel,
                            # pair jerk or None): the carry's, field taken off
    evaluations: Callable   # (integrator config) -> force evaluations a step
    work: Callable          # (n, steps, n_active_sum, evaluations) ->
                            # (pairs, flops a pair, bytes), ``roofline.py``
    fault: Callable         # (patch): the integrator loses its order
    frozen: Callable        # (patch): a step returns its state unchanged


def _kdk_pair(end, field):
    ext = field.accel(end.state.pos.to(F64)) if field is not None else 0.0
    return end.acc.to(F64) - ext, None


KINDS = {
    "kdk": Kind(
        step_method="step", carry_tensors=(), carry_host=(),
        warm_blocks=False, field=True, jerk=False, pair_force=_kdk_pair,
        evaluations=lambda ic: 1,
        work=lambda n, steps, active, ev: roofline.self_interaction(n, steps),
        fault=faults.kick_drift, frozen=faults.kdk_frozen),
    # the carry's jerk holds the field's, which the reference has not
    "hermite": Kind(
        step_method="_exec_step", carry_tensors=("jerk",),
        carry_host=("dt",), warm_blocks=False, field=False, jerk=True,
        pair_force=lambda end, field: (end.acc, end.jerk),
        evaluations=lambda ic: (1 + bool(ic.pec2)) * (1 + bool(ic.symmetrized)),
        work=lambda n, steps, active, ev: roofline.self_interaction_jerk(
            n, steps * ev),
        fault=faults.hermite_no_corrector, frozen=faults.hermite_frozen),
    "block": Kind(
        step_method="_micro_step",
        carry_tensors=("jerk", "a_ext", "j_ext", "t_i", "dt_i"),
        carry_host=("n_active_sum",), warm_blocks=True, field=True,
        jerk=True,
        pair_force=lambda end, field: (end.acc - end.a_ext,
                                       end.jerk - end.j_ext),
        evaluations=lambda ic: 1,
        work=lambda n, steps, active, ev: roofline.active_rows(n, steps,
                                                               active),
        fault=faults.block_no_corrector, frozen=faults.block_frozen),
}


def of(kind: str) -> Kind:
    if kind not in KINDS:
        raise ValueError(f"no stepper kind {kind!r} in the benchmark "
                         f"(it has {', '.join(KINDS)})")
    return KINDS[kind]


def least_seconds(kind: str, n: int, steps: int, n_active_sum: int = 0,
                  evaluations: int = 1):
    """The least time of the pair work of ``steps`` steps of the stepper
    ``kind`` at n particles, a step making ``evaluations`` force
    evaluations; (seconds, bound by)."""
    return roofline.bound(*of(kind).work(n, steps, n_active_sum,
                                         evaluations))
