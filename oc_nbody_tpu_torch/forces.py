"""ForceModel: pairwise self-gravity plus the static external field.

Counterpart of ``oc_nbody_tpu/forces.py`` on its unpruned, friction-free
path, at the f32 and the extended (hi/lo) precision tiers. The pairwise sum
goes through ``ops.cuda_gravity``, whose wrappers launch the CUDA kernels
for CUDA tensors and call their plain twins for CPU tensors: the tensors'
device makes the choice, there is no backend switch. So on the CPU the
extended tier runs the hi/lo twins of the same functions (the JAX package's
jnp backend evaluates some extended paths in f64 instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oc_nbody_tpu_torch.models.potentials import Potential
from oc_nbody_tpu_torch.ops import cuda_gravity, gravity

PRECISIONS = ("f32", "extended")


def check_precision(precision: str) -> None:
    """Raise for a precision tier the port does not run."""
    if precision == "df32":
        raise NotImplementedError(
            "precision = 'df32' (the two-float tier) is not ported yet "
            "(ROADMAP B8); the port runs 'f32' and 'extended'")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; the port runs "
                         f"{PRECISIONS}")


@dataclasses.dataclass(frozen=True)
class ForceModel:
    """Softening, G and an optional static external potential.

    ``eps`` and ``G`` are host floats, so a force evaluation never reads a
    device scalar. ``softened`` (eps > 0) lets the kernels drop the u > 0
    self-pair guard. ``precision`` picks the pairwise tier: ``"f32"``, or
    ``"extended"`` (hi/lo split positions and velocities, a lo-corrected
    separation and a Newton-refined rsqrt; kernels K6-K9)."""

    eps: float
    G: float
    external: Optional[Potential] = None
    softened: bool = False
    precision: str = "f32"

    @property
    def _extended(self) -> bool:
        return self.precision == "extended"

    def at_time(self, t) -> "ForceModel":
        """Bind the external field's evaluation time: a no-op, since only
        static fields are ported (time-dependent ones are ROADMAP A14)."""
        return self

    def accel(self, pos, mass):
        """Total acceleration, pairwise + external; (N, 3) in pos.dtype."""
        fn = cuda_gravity.accel_x if self._extended else cuda_gravity.accel
        acc = fn(pos, mass, self.eps, self.G, guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def accel_jerk(self, pos, vel, mass):
        """(accel, jerk), pairwise + external, in pos.dtype; the external
        jerk is the field's exact convective derivative (v·∇)a_ext."""
        fn = (cuda_gravity.accel_jerk_x if self._extended
              else cuda_gravity.accel_jerk)
        acc, jerk = fn(pos, vel, mass, self.eps, self.G,
                       guarded=not self.softened)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk

    def centred_sources(self, src_pos, src_vel, src_mass):
        """The sources as the pair kernels take them, then the two centres:
        (src_c, svel_c, mass_c, center, vcenter) — centred on their
        unweighted mean in f64, then cast to f32 — or, at the extended tier,
        (shi, slo, svhi, svlo, gm, center, vcenter), the centred f64 values
        split into (hi, lo) f32 planes and gm = G·m rounded to f32 once."""
        if self._extended:
            shi, slo, center = gravity.centre_split(src_pos)
            svhi, svlo, vcenter = gravity.centre_split(src_vel)
            return (shi, slo, svhi, svlo, gravity.gm_f32(src_mass, self.G),
                    center, vcenter)
        center = torch.mean(src_pos, dim=0)
        vcenter = torch.mean(src_vel, dim=0)
        f32 = torch.float32
        return ((src_pos - center).to(f32).contiguous(),
                (src_vel - vcenter).to(f32).contiguous(),
                src_mass.to(f32).contiguous(), center, vcenter)

    def pair_accel_jerk_rows(self, *planes):
        """The pairwise (accel, jerk) of centred rows from centred sources,
        f32 out. ``planes`` are the rows' planes, then the sources as
        ``centred_sources`` gives them: (rows_c, vrows_c, src_c, svel_c,
        mass_c) (K5, or K4 below RT_MIN_JERK sources), or at the extended
        tier (rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm) (K9)."""
        if self._extended:
            return cuda_gravity.accel_jerk_rows_x_hilo(
                *planes, self.eps, guarded=not self.softened)
        return cuda_gravity.accel_jerk_rows(*planes, self.eps, self.G,
                                            guarded=not self.softened)

    def accel_jerk_on_rows(self, pos_rows, vel_rows, src_pos, src_vel,
                           src_mass, rows_mask=None):
        """(accel, jerk) on a row subset against the full source set, in
        pos_rows.dtype: the block-timestep active-set evaluation. Rows and
        sources are centred on the unweighted source mean in f64 before the
        f32 cast (or the hi/lo split); the external field acts on the raw
        row positions. ``rows_mask`` is the escape-pruning membership, not
        ported yet."""
        if rows_mask is not None:
            raise NotImplementedError(
                "accel_jerk_on_rows with rows_mask (escape pruning) is not "
                "ported yet (ROADMAP A15)")
        *sources, center, vcenter = self.centred_sources(src_pos, src_vel,
                                                         src_mass)
        if self._extended:
            rows = cuda_gravity.split_rows_x(pos_rows, vel_rows, center,
                                             vcenter)
        else:
            f32 = torch.float32
            rows = ((pos_rows - center).to(f32).contiguous(),
                    (vel_rows - vcenter).to(f32).contiguous())
        acc, jerk = self.pair_accel_jerk_rows(*rows, *sources)
        acc = acc.to(pos_rows.dtype)
        jerk = jerk.to(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk

    def accel_potential(self, pos, mass):
        """(accel, phi_pair, phi_ext); potentials are per-particle."""
        if self._extended:
            # the tier's phi is raw: it holds the softened self term
            # -G m/eps, cancelled here in f64 (the f32 wrappers do it
            # themselves)
            acc, phi_pair = cuda_gravity.accel_potential_x(
                pos, mass, self.eps, self.G, guarded=not self.softened)
            phi_pair = phi_pair + gravity.self_phi(mass.to(phi_pair.dtype),
                                                   self.eps, self.G)
        else:
            acc, phi_pair = cuda_gravity.accel_potential(
                pos, mass, self.eps, self.G, guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
            phi_ext = self.external.phi(pos)
        else:
            phi_ext = torch.zeros_like(phi_pair)
        return acc, phi_pair, phi_ext


def make_force_model(eps, G=1.0, external: Optional[Potential] = None,
                     precision: str = "f32") -> ForceModel:
    check_precision(precision)
    return ForceModel(eps=float(eps), G=float(G), external=external,
                      softened=float(eps) > 0, precision=precision)
