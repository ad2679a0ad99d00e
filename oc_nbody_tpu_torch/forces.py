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

    def centred_sources(self, src_pos, src_vel, src_mass):
        """(src_c, svel_c, mass_c, center, vcenter): the sources centred on
        their unweighted mean, in f64, then cast to f32."""
        center = torch.mean(src_pos, dim=0)
        vcenter = torch.mean(src_vel, dim=0)
        f32 = torch.float32
        return ((src_pos - center).to(f32).contiguous(),
                (src_vel - vcenter).to(f32).contiguous(),
                src_mass.to(f32).contiguous(), center, vcenter)

    def pair_accel_jerk_rows(self, rows_c, vrows_c, src_c, svel_c, mass_c):
        """The pairwise (accel, jerk) of centred f32 rows from centred f32
        sources, f32 out (K5, or K4 below RT_MIN_JERK sources)."""
        return cuda_gravity.accel_jerk_rows(rows_c, vrows_c, src_c, svel_c,
                                            mass_c, self.eps, self.G,
                                            guarded=not self.softened)

    def accel_jerk_on_rows(self, pos_rows, vel_rows, src_pos, src_vel,
                           src_mass, rows_mask=None):
        """(accel, jerk) on a row subset against the full source set, in
        pos_rows.dtype: the block-timestep active-set evaluation. Rows and
        sources are centred on the unweighted source mean in f64 before the
        f32 cast; the external field acts on the raw row positions.
        ``rows_mask`` is the escape-pruning membership, not ported yet."""
        if rows_mask is not None:
            raise NotImplementedError(
                "accel_jerk_on_rows with rows_mask (escape pruning) is not "
                "ported yet (ROADMAP A15)")
        src_c, svel_c, mass_c, center, vcenter = self.centred_sources(
            src_pos, src_vel, src_mass)
        f32 = torch.float32
        acc, jerk = self.pair_accel_jerk_rows(
            (pos_rows - center).to(f32).contiguous(),
            (vel_rows - vcenter).to(f32).contiguous(), src_c, svel_c, mass_c)
        acc = acc.to(pos_rows.dtype)
        jerk = jerk.to(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
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
