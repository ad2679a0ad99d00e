"""Integrator faults planted under the timed path, two for each stepper
kind; ``kinds.KINDS`` names a kind's own as its ``fault`` and ``frozen``.
Each takes ``patch(owner, name, value)``: ``setattr`` in a process of its
own, or pytest's ``monkeypatch.setattr``.

The ``fault``: the integrator loses its order and keeps everything else.
Its runs set the upper end of ``drift``'s limit (``readings.py
--fault-seeds``), and the tests see them fail.

  kdk      the kick-drift step (symplectic Euler, first order): one full
           kick with the step's opening force, then one full drift.
  hermite  the Hermite corrector left out (``hermite._correct``, which
           ``Hermite4.propose`` calls, once or with pec2 twice): each star
           keeps its prediction (positions to second order, velocities to
           first); the force, the jerk and the next dt are still evaluated
           as the step evaluates them.
  block    the Hermite corrector left out (``BlockHermite._corrector``):
           each active star keeps its prediction (positions to second
           order, velocities to first).

The ``frozen`` step returns its state unchanged (the time moves on), for
the tests.
"""
from __future__ import annotations


def kick_drift(patch) -> None:
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


def hermite_no_corrector(patch) -> None:
    from oc_nbody_tpu_torch.integrators import hermite

    def predicted(pos, vel, a0, j0, a1, j1, dt):
        return pos + dt * vel + (dt * dt / 2) * a0, vel + dt * a0
    patch(hermite, "_correct", predicted)


def block_no_corrector(patch) -> None:
    from oc_nbody_tpu_torch.integrators.block import BlockHermite

    def corrector(self, h, pos, vel, a0, j0, a1, j1):
        return pos + h * vel + (h * h / 2) * a0, vel + h * a0
    patch(BlockHermite, "_corrector", corrector)


def kdk_frozen(patch) -> None:
    from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
    step = LeapfrogKDK.step

    def frozen(self, carry):
        new = step(self, carry)
        return new.replace(state=carry.state.replace(time=new.state.time),
                           acc=carry.acc)
    patch(LeapfrogKDK, "step", frozen)


def hermite_frozen(patch) -> None:
    from oc_nbody_tpu_torch.integrators.hermite import Hermite4
    exec_step = Hermite4._exec_step

    def frozen(self, carry, dt_cap):
        new = exec_step(self, carry, dt_cap)
        return new.replace(state=carry.state.replace(time=new.state.time),
                           acc=carry.acc, jerk=carry.jerk)
    patch(Hermite4, "_exec_step", frozen)


def block_frozen(patch) -> None:
    from oc_nbody_tpu_torch.integrators.block import BlockHermite
    micro = BlockHermite._micro_step

    def frozen(self, carry, *a, **kw):
        new = micro(self, carry, *a, **kw)
        if new is None:
            return None
        return new.replace(state=new.state.replace(pos=carry.state.pos,
                                                   vel=carry.state.vel))
    patch(BlockHermite, "_micro_step", frozen)

