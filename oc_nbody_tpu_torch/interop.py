"""Carry a particle state, or a Hermite carry, between the JAX package and
the port as numpy arrays, with the reference dtypes (pos/vel/acc/jerk f64,
mass f32, ids i32, time and dt f64, n_steps i64). Used by the tests to give
both packages identical inputs. Takes and returns numpy only; imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from oc_nbody_tpu_torch.integrators.hermite import HermiteCarry
from oc_nbody_tpu_torch.state import ParticleState, make_state


def state_from_numpy(pos, vel, mass, ids, time, device) -> ParticleState:
    """A port ParticleState on ``device`` from numpy-convertible arrays (for
    example ``np.asarray`` of each field of a JAX ParticleState)."""
    return make_state(
        torch.from_numpy(np.asarray(pos, np.float64)),
        torch.from_numpy(np.asarray(vel, np.float64)),
        torch.from_numpy(np.asarray(mass, np.float32)),
        ids=torch.from_numpy(np.asarray(ids, np.int32)),
        time=float(np.asarray(time, np.float64)), device=device)


def state_to_numpy(state: ParticleState):
    """(pos, vel, mass, ids, time) as numpy arrays in the reference dtypes —
    the argument order of ``state_from_numpy`` and of the JAX package's
    ``make_state``."""
    return (state.pos.detach().cpu().numpy().astype(np.float64),
            state.vel.detach().cpu().numpy().astype(np.float64),
            state.mass.detach().cpu().numpy().astype(np.float32),
            state.ids.detach().cpu().numpy().astype(np.int32),
            np.float64(state.time))


def hermite_carry_from_numpy(pos, vel, mass, ids, time, acc, jerk, dt,
                             n_steps, device) -> HermiteCarry:
    """A port HermiteCarry on ``device`` from the fields of a Hermite carry
    (for example ``np.asarray`` of each field of a JAX HermiteCarry), so
    the port continues a run where the JAX package left it."""
    state = state_from_numpy(pos, vel, mass, ids, time, device)
    return HermiteCarry(
        state=state,
        acc=torch.from_numpy(np.asarray(acc, np.float64)).to(device),
        jerk=torch.from_numpy(np.asarray(jerk, np.float64)).to(device),
        dt=float(np.asarray(dt, np.float64)),
        n_steps=int(np.asarray(n_steps, np.int64)))


def hermite_carry_to_numpy(carry: HermiteCarry):
    """(pos, vel, mass, ids, time, acc, jerk, dt, n_steps) as numpy arrays
    in the reference dtypes — the argument order of
    ``hermite_carry_from_numpy``."""
    return (*state_to_numpy(carry.state),
            carry.acc.detach().cpu().numpy().astype(np.float64),
            carry.jerk.detach().cpu().numpy().astype(np.float64),
            np.float64(carry.dt), np.int64(carry.n_steps))
