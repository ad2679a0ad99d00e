"""4th-order Hermite predictor–corrector with a shared adaptive timestep.

Counterpart of ``Hermite4`` in ``oc_nbody_tpu/integrators/hermite.py``,
the classic Makino–Aarseth (1992) two-point Hermite method:

  predict : x_p = x + v dt + a dt²/2 + j dt³/6 ;  v_p = v + a dt + j dt²/2
  evaluate: (a1, j1) at (x_p, v_p)                [the O(N²) hot call]
  correct : v1 = v + dt/2 (a0+a1) + dt²/12 (j0−j1)
            x1 = x + dt/2 (v+v1)  + dt²/12 (a0−a1)
  dt      : Aarseth criterion from the interpolated 2nd/3rd derivatives,
            shared = min over particles, growth-limited, optionally
            quantized to dt_max/2^k.

Host and device. The JAX package runs the whole ``advance_to`` as one
device loop. Here time, the step count and the shared dt live on the host
as Python numbers, as in ``LeapfrogKDK``: the step's device work (predict,
evaluate, correct, the Aarseth criterion reduced to one 0-d tensor) is
enqueued, then the criterion is read back — the one device sync of a step
(two with ``symmetrized``) — and the growth limit, the landing clip, the
clamps and the quantization are applied on host floats. Every one of those
operations is the f64 arithmetic the JAX package does on device, so the
port takes the same steps to the same times on the same IC.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from oc_nbody_tpu_torch.forces import ForceModel
from oc_nbody_tpu_torch.state import ParticleState
from oc_nbody_tpu_torch.utils.profiling import span

_TINY = torch.finfo(torch.float64).tiny
# the quantization rung selector is log(x)/log(2), as jnp.log2 computes it:
# it picks JAX's rung at and next to every power of two below 2^29
# (math.log2 rounds 16·(1 + 2^-52) to 4 and would pick one rung higher)
_LN2 = math.log(2.0)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


# ---- step math (line for line the JAX package's) ----------------------

def _correct(pos, vel, a0, j0, a1, j1, dt):
    """One Hermite corrector application (v first, then x from v1)."""
    dt2 = dt * dt
    v1 = vel + (dt / 2) * (a0 + a1) + (dt2 / 12) * (j0 - j1)
    x1 = pos + (dt / 2) * (vel + v1) + (dt2 / 12) * (a0 - a1)
    return x1, v1


def _interp_derivs(a0, j0, a1, j1, dt):
    """Interpolated (a², a³) at t0, a² shifted to t1."""
    dt2, dt3 = dt * dt, dt * dt * dt
    inv_dt2 = 1.0 / max(dt2, _TINY)
    inv_dt3 = 1.0 / max(dt3, _TINY)
    a2_0 = (-6.0 * (a0 - a1) - dt * (4.0 * j0 + 2.0 * j1)) * inv_dt2
    a3 = (12.0 * (a0 - a1) + 6.0 * dt * (j0 + j1)) * inv_dt3
    a2_1 = a2_0 + dt * a3
    return a2_1, a3


def _aarseth_shared_dt(a1, j1, a2_1, a3, eta):
    """The shared Aarseth step, a 0-d device tensor (inf if no particle
    constrains it)."""
    na, nj = _norm(a1), _norm(j1)
    n2, n3 = _norm(a2_1), _norm(a3)
    num = na * n2 + nj * nj
    den = nj * n3 + n2 * n2
    dt2 = eta * num / torch.clamp(den, min=_TINY)
    dt_i = torch.sqrt(dt2)
    return torch.min(torch.where(den > 0, dt_i, math.inf))


def _shape_dt_fn(dt: float, dt_min: float, dt_max: float,
                 quantize: bool) -> float:
    dt = min(max(dt, dt_min), dt_max)
    if quantize:
        # largest dt_max/2^k <= dt, k >= 0, built as dt_max * (1 / 2^k)
        # with the power of two an exact integer shift; log is only the
        # rung selector
        k = math.ceil(math.log(dt_max / max(dt, 1e-300)) / _LN2)
        k = min(max(k, 0), 62)
        dt = dt_max / float(1 << k)
        # quantization rounds DOWN and can land below dt_min: the safety
        # clamp wins over the grid
        dt = max(dt, dt_min)
    return dt


def _stop_time(t_end: float) -> float:
    """The JAX advance_to's loop bound: step while time < this."""
    sign = (t_end > 0) - (t_end < 0)
    return t_end * (1 - sign * 1e-14) - 1e-300


@dataclasses.dataclass(frozen=True)
class HermiteCarry:
    state: ParticleState
    acc: torch.Tensor       # (N, 3) at state.time
    jerk: torch.Tensor      # (N, 3) at state.time
    dt: float               # shared timestep of the next step (host)
    n_steps: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Hermite4:
    """Shared-adaptive-dt Hermite-4 stepper.

    ``pec2``: a second (evaluate, correct) pass at the corrected state.
    ``symmetrized``: the executed dt is the shaped mean of the criterion at
    the step's start (the carried dt) and at a trial step's end (Hut,
    Makino & McMillan 1995), at one extra force evaluation per step."""

    force: ForceModel
    eta: float = 0.02          # Aarseth accuracy parameter
    eta_init: float = 0.01     # startup criterion scale
    dt_max: float = math.inf   # upper clamp
    dt_min: float = 0.0        # lower clamp (safety)
    quantize: bool = False     # snap dt to dt_max / 2^k
    pec2: bool = False
    symmetrized: bool = False

    def __post_init__(self):
        if self.quantize and not math.isfinite(float(self.dt_max)):
            raise ValueError(
                "quantize=True requires a finite dt_max (the quantization "
                "grid is dt_max / 2^k)")

    def _shape_dt(self, dt: float) -> float:
        return _shape_dt_fn(dt, self.dt_min, self.dt_max, self.quantize)

    def _accel_jerk(self, pos, vel, mass, t):
        a, j = self.force.at_time(t).accel_jerk(pos, vel, mass)
        return a.to(pos.dtype), j.to(pos.dtype)

    def init(self, state: ParticleState) -> HermiteCarry:
        acc, jerk = self._accel_jerk(state.pos, state.vel, state.mass,
                                     state.time)
        a, j = _norm(acc), _norm(jerk)
        ratio = torch.where(j > 0, a / torch.clamp(j, min=_TINY), math.inf)
        dt0 = self.eta_init * float(torch.min(ratio))
        dt0 = min(dt0, self.dt_max)
        if not math.isfinite(dt0):
            dt0 = self.dt_max
        return HermiteCarry(state=state, acc=acc, jerk=jerk,
                            dt=self._shape_dt(dt0), n_steps=0)

    def propose(self, carry: HermiteCarry, dt: float):
        """The device half of a step of size ``dt``: predict, evaluate,
        correct (twice with pec2). Returns (x1, v1, a1, j1, crit) with
        ``crit`` the new Aarseth dt as a 0-d device tensor, not yet read."""
        s, a0, j0 = carry.state, carry.acc, carry.jerk
        dt2, dt3 = dt * dt, dt * dt * dt
        xp = s.pos + dt * s.vel + (dt2 / 2) * a0 + (dt3 / 6) * j0
        vp = s.vel + dt * a0 + (dt2 / 2) * j0
        # predictor/corrector evaluations happen at the step's END time
        t1 = s.time + dt
        a1, j1 = self._accel_jerk(xp, vp, s.mass, t1)
        x1, v1 = _correct(s.pos, s.vel, a0, j0, a1, j1, dt)
        if self.pec2:
            a1, j1 = self._accel_jerk(x1, v1, s.mass, t1)
            x1, v1 = _correct(s.pos, s.vel, a0, j0, a1, j1, dt)
        a2_1, a3 = _interp_derivs(a0, j0, a1, j1, dt)
        return x1, v1, a1, j1, _aarseth_shared_dt(a1, j1, a2_1, a3, self.eta)

    def _step_with_dt(self, carry: HermiteCarry, dt: float) -> HermiteCarry:
        x1, v1, a1, j1, crit = self.propose(carry, dt)
        with span("integrator.wait", site="hermite.dt"):
            dt_new = float(crit)  # the step's one device read
        if math.isnan(dt_new):
            raise FloatingPointError(
                f"Hermite timestep criterion is NaN at t={carry.state.time:.6g}"
                f" (dt={dt:.6g})")
        # growth limit against the CARRIED dt, not the executed one: a
        # boundary-clipped landing step (dt << carry.dt) carries the
        # previous dt forward unchanged
        dt_new = min(dt_new, 2.0 * carry.dt)
        if not dt >= 0.25 * carry.dt:
            dt_new = carry.dt
        s = carry.state
        return HermiteCarry(
            state=s.replace(pos=x1, vel=v1, time=s.time + dt), acc=a1,
            jerk=j1, dt=self._shape_dt(dt_new), n_steps=carry.n_steps + 1)

    def _exec_step(self, carry: HermiteCarry, dt_cap: float) -> HermiteCarry:
        """One step under an upper dt bound (the advance_to landing clip);
        with ``symmetrized`` a trial step at the carried dt first."""
        with span("integrator.step"):
            dt = min(carry.dt, dt_cap)
            if not self.symmetrized:
                return self._step_with_dt(carry, dt)
            trial = self._step_with_dt(carry, dt)
            dt_s = min(self._shape_dt(0.5 * (carry.dt + trial.dt)), dt_cap)
            return self._step_with_dt(carry, dt_s)

    def step(self, carry: HermiteCarry) -> HermiteCarry:
        return self._exec_step(carry, math.inf)

    def advance(self, carry: HermiteCarry, n: int) -> HermiteCarry:
        """n steps."""
        for _ in range(n):
            carry = self.step(carry)
        return carry

    def advance_to(self, carry: HermiteCarry, t_end: float) -> HermiteCarry:
        """Step until state.time reaches t_end, the last step clipped to
        land on it (the JAX package's loop bound, on host floats)."""
        t_end = float(t_end)
        stop = _stop_time(t_end)
        while carry.state.time < stop:
            carry = self._exec_step(carry, t_end - carry.state.time)
        return carry

    def with_force(self, force: ForceModel):
        """This stepper with another force model (a re-partition of escape
        pruning)."""
        return dataclasses.replace(self, force=force)

    def reached(self, carry: HermiteCarry, t_end: float) -> bool:
        te = float(t_end)
        return carry.state.time >= te - 1e-14 * abs(te) - 1e-300

    def checkpoint_aux(self, carry: HermiteCarry) -> dict:
        """Arrays a checkpoint must hold for a bitwise resume."""
        return {"acc": carry.acc, "jerk": carry.jerk, "dt": carry.dt,
                "n_steps": carry.n_steps}
