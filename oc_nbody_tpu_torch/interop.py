"""Carry a particle state, a Hermite carry or a block carry between the JAX
package and the port as numpy arrays, with the reference dtypes
(pos/vel/acc/jerk/a_ext/j_ext f64, mass f32, ids i32, time, dt and t_origin
f64, n_steps, n_active_sum and the block grid t_i/dt_i i64). Used by the tests to give
both packages identical inputs. Takes and returns numpy only; imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from oc_nbody_tpu_torch.integrators.block import BlockCarry
from oc_nbody_tpu_torch.integrators.hermite import HermiteCarry
from oc_nbody_tpu_torch.state import ParticleState, make_state


def state_from_numpy(pos, vel, mass, ids, time, device) -> ParticleState:
    """A port ParticleState on ``device`` from numpy-convertible arrays (for
    example ``np.asarray`` of each field of a JAX ParticleState)."""
    return make_state(
        torch.from_numpy(np.array(pos, np.float64)),
        torch.from_numpy(np.array(vel, np.float64)),
        torch.from_numpy(np.array(mass, np.float32)),
        ids=torch.from_numpy(np.array(ids, np.int32)),
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
        acc=torch.from_numpy(np.array(acc, np.float64)).to(device),
        jerk=torch.from_numpy(np.array(jerk, np.float64)).to(device),
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


def block_carry_from_numpy(pos, vel, mass, ids, time, acc, jerk, a_ext,
                           j_ext, t_i, dt_i, t_origin, n_steps, n_active_sum,
                           device) -> BlockCarry:
    """A port BlockCarry on ``device`` from the fields of a block carry (for
    example ``np.asarray`` of each field of a JAX BlockCarry); t_i and dt_i
    stay int64."""
    def f64(a):
        return torch.from_numpy(np.array(a, np.float64)).to(device)

    def i64(a):
        return torch.from_numpy(np.array(a, np.int64)).to(device)

    return BlockCarry(
        state=state_from_numpy(pos, vel, mass, ids, time, device),
        acc=f64(acc), jerk=f64(jerk), a_ext=f64(a_ext), j_ext=f64(j_ext),
        t_i=i64(t_i), dt_i=i64(dt_i),
        t_origin=float(np.asarray(t_origin, np.float64)),
        n_steps=int(np.asarray(n_steps, np.int64)),
        n_active_sum=int(np.asarray(n_active_sum, np.int64)))


def block_carry_to_numpy(carry: BlockCarry):
    """(pos, vel, mass, ids, time, acc, jerk, a_ext, j_ext, t_i, dt_i,
    t_origin, n_steps, n_active_sum) as numpy arrays in the reference dtypes
    — the argument order of ``block_carry_from_numpy``."""
    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def i64(t):
        return t.detach().cpu().numpy().astype(np.int64)

    return (*state_to_numpy(carry.state), f64(carry.acc), f64(carry.jerk),
            f64(carry.a_ext), f64(carry.j_ext), i64(carry.t_i),
            i64(carry.dt_i), np.float64(carry.t_origin),
            np.int64(carry.n_steps), np.int64(carry.n_active_sum))
