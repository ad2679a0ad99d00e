"""KDK leapfrog (kick–drift–kick) with a fixed timestep.

Counterpart of ``LeapfrogKDK`` in ``oc_nbody_tpu/integrators/leapfrog.py``:
symplectic, time-reversible, one force evaluation per step (the closing
kick's acceleration is cached as the next step's opening kick). Positions
and velocities update in f64; the pairwise force runs in f32 on centred
offsets inside the force model.

Time and the step count live on the host as a Python float and int, and
the number of steps to an output time follows the reference's
``1e-12·|t_end|`` rule on host floats, so the step loop only enqueues
device work and never waits for the device.
"""
from __future__ import annotations

import dataclasses

import torch

from oc_nbody_tpu_torch.forces import ForceModel
from oc_nbody_tpu_torch.state import ParticleState
from oc_nbody_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class KDKCarry:
    state: ParticleState
    acc: torch.Tensor       # cached total acceleration at state.time
    n_steps: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _stop_time(t_end: float) -> float:
    return t_end - 1e-12 * abs(t_end)


@dataclasses.dataclass(frozen=True)
class LeapfrogKDK:
    """Fixed-dt KDK leapfrog stepper."""

    force: ForceModel
    dt: float

    def init(self, state: ParticleState) -> KDKCarry:
        acc = self.force.at_time(state.time).accel(state.pos, state.mass)
        return KDKCarry(state=state, acc=acc.to(state.pos.dtype), n_steps=0)

    def step(self, carry: KDKCarry) -> KDKCarry:
        with span("integrator.step"):
            s, acc, dt = carry.state, carry.acc, self.dt
            v_half = s.vel + (0.5 * dt) * acc
            pos_new = s.pos + dt * v_half
            # the closing force eval is at the step's END time (a no-op
            # binding for the static fields ported so far)
            acc_new = self.force.at_time(s.time + dt).accel(
                pos_new, s.mass).to(s.pos.dtype)
            vel_new = v_half + (0.5 * dt) * acc_new
            state_new = s.replace(pos=pos_new, vel=vel_new, time=s.time + dt)
        return KDKCarry(state=state_new, acc=acc_new,
                        n_steps=carry.n_steps + 1)

    def advance(self, carry: KDKCarry, n: int) -> KDKCarry:
        """n steps."""
        for _ in range(n):
            carry = self.step(carry)
        return carry

    def advance_to(self, carry: KDKCarry, t_end: float) -> KDKCarry:
        """Step until state.time >= t_end (whole steps; fixed dt)."""
        stop = _stop_time(float(t_end))
        while carry.state.time < stop:
            carry = self.step(carry)
        return carry

    def with_force(self, force: ForceModel):
        """This stepper with another force model (a re-partition of escape
        pruning)."""
        return dataclasses.replace(self, force=force)

    def reached(self, carry: KDKCarry, t_end: float) -> bool:
        return carry.state.time >= _stop_time(float(t_end))

    def checkpoint_aux(self, carry: KDKCarry) -> dict:
        """Arrays a checkpoint must hold for a bitwise resume."""
        return {"acc": carry.acc, "n_steps": carry.n_steps}
