"""Particle state: a plain dataclass of tensors on one device.

Counterpart of ``oc_nbody_tpu/state.py`` with the same dtypes: positions
and velocities f64, masses f32, ids i32. ``time`` is a Python float (f64)
kept on the host, so the step loop never reads a device scalar.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Struct-of-arrays particle state.

    Attributes:
      pos:  (N, 3) positions, float64.
      vel:  (N, 3) velocities, float64.
      mass: (N,) masses, float32.
      ids:  (N,) stable particle identifiers, int32.
      time: simulation time, a host float.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    ids: torch.Tensor
    time: float

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.mass.to(torch.float64))

    def com(self) -> torch.Tensor:
        """Centre of mass, (3,) float64."""
        m = self.mass.to(torch.float64)
        return torch.sum(self.pos * m[:, None], dim=0) / torch.sum(m)

    def com_vel(self) -> torch.Tensor:
        m = self.mass.to(torch.float64)
        return torch.sum(self.vel * m[:, None], dim=0) / torch.sum(m)

    def shifted(self, dpos=None, dvel=None) -> "ParticleState":
        """Return a copy translated in phase space (orbit placement)."""
        new = self
        if dpos is not None:
            new = new.replace(pos=new.pos + torch.as_tensor(
                dpos, dtype=new.pos.dtype, device=new.device))
        if dvel is not None:
            new = new.replace(vel=new.vel + torch.as_tensor(
                dvel, dtype=new.vel.dtype, device=new.device))
        return new

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ParticleState":
        return self.replace(pos=self.pos.to(device), vel=self.vel.to(device),
                            mass=self.mass.to(device),
                            ids=self.ids.to(device))


def make_state(pos, vel, mass, ids=None, time: float = 0.0,
               device=None) -> ParticleState:
    """Build a ParticleState with the canonical dtypes on ``device``
    (default: the device ``pos`` is on, or the CPU)."""
    if device is None:
        device = pos.device if isinstance(pos, torch.Tensor) else "cpu"
    pos = torch.as_tensor(pos, dtype=torch.float64, device=device)
    vel = torch.as_tensor(vel, dtype=torch.float64, device=device)
    mass = torch.as_tensor(mass, dtype=torch.float32, device=device)
    n = pos.shape[0]
    if pos.shape != (n, 3) or vel.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(f"bad shapes: pos {tuple(pos.shape)}, vel "
                         f"{tuple(vel.shape)}, mass {tuple(mass.shape)}")
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=device)
    else:
        ids = torch.as_tensor(ids, dtype=torch.int32, device=device)
    return ParticleState(pos=pos.contiguous(), vel=vel.contiguous(),
                         mass=mass.contiguous(), ids=ids, time=float(time))
