"""Integrator faults planted under the timed path, for the readings that
set the upper end of ``drift``'s limit (``readings.py --fault-seeds``) and
for the tests: each loses the integrator's order and keeps everything else.

  kdk    the kick-drift step (symplectic Euler, first order): one full kick
         with the step's opening force, then one full drift.
  block  the Hermite corrector left out: each active star keeps its
         prediction (positions to second order, velocities to first).

``plant(kind, patch)`` plants the stepper kind's fault with
``patch(owner, name, value)``: ``setattr`` in a process of its own, or
pytest's ``monkeypatch.setattr``.
"""
from __future__ import annotations


def _kick_drift(patch) -> None:
    from oc_nbody_tpu_torch.integrators.leapfrog import KDKCarry, LeapfrogKDK

    def step(self, carry):
        s, dt = carry.state, self.dt
        vel = s.vel + dt * carry.acc
        pos = s.pos + dt * vel
        acc = self.force.at_time(s.time + dt).accel(pos, s.mass).to(
            s.pos.dtype)
        return KDKCarry(state=s.replace(pos=pos, vel=vel, time=s.time + dt),
                        acc=acc, n_steps=carry.n_steps + 1)
    patch(LeapfrogKDK, "step", step)


def _no_corrector(patch) -> None:
    from oc_nbody_tpu_torch.integrators.block import BlockHermite

    def corrector(self, h, pos, vel, a0, j0, a1, j1):
        return pos + h * vel + (h * h / 2) * a0, vel + h * a0
    patch(BlockHermite, "_corrector", corrector)


FAULTS = {"kdk": _kick_drift, "block": _no_corrector}


def plant(kind: str, patch=setattr) -> None:
    FAULTS[kind](patch)
