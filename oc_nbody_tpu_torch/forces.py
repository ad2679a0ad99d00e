"""ForceModel: pairwise self-gravity plus the static external field.

Counterpart of ``oc_nbody_tpu/forces.py`` on its f32, unpruned,
friction-free path. The pairwise sum goes through
``ops.cuda_gravity``, whose wrappers launch the CUDA kernels for CUDA
tensors and call their plain twins for CPU tensors: the tensors' device
makes the choice, there is no backend switch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oc_nbody_tpu_torch.models.potentials import Potential
from oc_nbody_tpu_torch.ops import cuda_gravity


@dataclasses.dataclass(frozen=True)
class ForceModel:
    """Softening, G and an optional static external potential.

    ``eps`` and ``G`` are host floats, so a force evaluation never reads a
    device scalar. ``softened`` (eps > 0) lets the kernels drop the u > 0
    self-pair guard."""

    eps: float
    G: float
    external: Optional[Potential] = None
    softened: bool = False

    def at_time(self, t) -> "ForceModel":
        """Bind the external field's evaluation time: a no-op, since only
        static fields are ported (time-dependent ones are ROADMAP A14)."""
        return self

    def accel(self, pos, mass):
        """Total acceleration, pairwise + external; (N, 3) in pos.dtype."""
        acc = cuda_gravity.accel(pos, mass, self.eps, self.G,
                                 guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def accel_jerk(self, pos, vel, mass):
        """(accel, jerk), pairwise + external, in pos.dtype; the external
        jerk is the field's exact convective derivative (v·∇)a_ext."""
        acc, jerk = cuda_gravity.accel_jerk(pos, vel, mass, self.eps, self.G,
                                            guarded=not self.softened)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk

    def accel_potential(self, pos, mass):
        """(accel, phi_pair, phi_ext); potentials are per-particle."""
        acc, phi_pair = cuda_gravity.accel_potential(
            pos, mass, self.eps, self.G, guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
            phi_ext = self.external.phi(pos)
        else:
            phi_ext = torch.zeros_like(phi_pair)
        return acc, phi_pair, phi_ext


def make_force_model(eps, G=1.0,
                     external: Optional[Potential] = None) -> ForceModel:
    return ForceModel(eps=float(eps), G=float(G), external=external,
                      softened=float(eps) > 0)
