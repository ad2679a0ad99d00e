"""ForceModel: pairwise self-gravity plus the static external field.

Counterpart of ``oc_nbody_tpu/forces.py`` on its unpruned, friction-free
path, at the f32, the extended (hi/lo) and the two-float (df32) precision
tiers. The pairwise sum goes through ``ops.cuda_gravity`` and
``ops.cuda_df``, whose wrappers launch the CUDA kernels for CUDA tensors
and call their plain twins for CPU tensors: the tensors' device makes the
choice, there is no backend switch. So on the CPU the extended tier runs
the hi/lo twins of the same functions (the JAX package's jnp backend
evaluates some extended paths in f64 instead).

The df32 tier's routes, beside the JAX package's (forces.py:327-411,
:776-789):
  * ``accel`` -> the two-float kernel K10 (JAX on the TPU: its Pallas
    counterpart; on the CPU: the jnp twin, as here);
  * ``accel_jerk`` -> the two-float kernel K11. A deliberate divergence on
    the card: the JAX package routes this call around its own two-float
    jerk kernel to XLA's emulated f64, which measured faster on the TPU.
    On the H100 the alternative is eager f64 PyTorch, which ``chip_smoke.py``
    times beside K11: 80.7 ms against K11's 4.4 ms at N = 16,384, 23.4
    against 1.1 at 8,192 (NVIDIA H100 80GB HBM3, 700 W power limit;
    PERF.md section 7). On the CPU both packages run the two-float twin;
  * ``accel_potential`` -> the blocked f64 pair sum of ``ops/gravity.py`` on
    either device, as the JAX package's TPU route; its potential excludes
    the self term, so no ``self_phi`` is added here;
  * the block stepper's active rows (``accel_jerk_on_rows``,
    ``centred_sources``, ``pair_accel_jerk_rows``) -> the f64 rows sum of
    ``ops/gravity.py`` on the raw f64 rows and sources, as the JAX package
    on every backend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oc_nbody_tpu_torch.models.potentials import Potential
from oc_nbody_tpu_torch.ops import cuda_df, cuda_gravity, gravity

PRECISIONS = ("f32", "extended", "df32")
# row chunk of the f64 sums the df32 tier takes outside its kernels (the
# JAX package's min(chunk, 256))
_F64_CHUNK = 256


def check_precision(precision: str) -> None:
    """Raise for a precision tier the port does not know."""
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
    separation and a Newton-refined rsqrt; kernels K6-K9, past STREAM_N
    K15-K17), or ``"df32"`` (every pair quantity a two-float number;
    kernels K10 and K11, f64 sums for the potential and the block
    stepper's active rows)."""

    eps: float
    G: float
    external: Optional[Potential] = None
    softened: bool = False
    precision: str = "f32"

    @property
    def _extended(self) -> bool:
        return self.precision == "extended"

    @property
    def _df32(self) -> bool:
        return self.precision == "df32"

    @property
    def pair_dtype(self) -> torch.dtype:
        """The dtype ``pair_accel_jerk_rows`` returns."""
        return torch.float64 if self._df32 else torch.float32

    def at_time(self, t) -> "ForceModel":
        """Bind the external field's evaluation time: a no-op, since only
        static fields are ported (time-dependent ones are ROADMAP A14)."""
        return self

    def accel(self, pos, mass):
        """Total acceleration, pairwise + external; (N, 3) in pos.dtype."""
        fn = {"f32": cuda_gravity.accel, "extended": cuda_gravity.accel_x,
              "df32": cuda_df.accel_df}[self.precision]
        acc = fn(pos, mass, self.eps, self.G, guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def accel_jerk(self, pos, vel, mass):
        """(accel, jerk), pairwise + external, in pos.dtype; the external
        jerk is the field's exact convective derivative (v·∇)a_ext."""
        fn = {"f32": cuda_gravity.accel_jerk,
              "extended": cuda_gravity.accel_jerk_x,
              "df32": cuda_df.accel_jerk_df}[self.precision]
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
        split into (hi, lo) f32 planes and gm = G·m rounded to f32 once. At
        the df32 tier the pair sum is f64 and needs no centring: (src_pos,
        src_vel, mass in f64, None, None)."""
        if self._df32:
            f64 = torch.float64
            return (src_pos.to(f64), src_vel.to(f64), src_mass.to(f64), None,
                    None)
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
        tier (rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm) (K9). At the
        df32 tier (rows, vrows, src, svel, mass), all f64 and uncentred,
        through the plain f64 rows sum, f64 out."""
        if self._df32:
            return gravity.accel_jerk_rows(*planes, self.eps, self.G,
                                           _F64_CHUNK)
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
        if self._df32:
            f64 = torch.float64
            rows = (pos_rows.to(f64), vel_rows.to(f64))
        elif self._extended:
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
        if self._df32:
            # the blocked f64 sum: its phi has no self term to cancel
            acc, phi_pair = gravity.accel_potential(
                pos, mass, self.eps, self.G, compute_dtype=torch.float64,
                chunk=_F64_CHUNK)
        elif self._extended:
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
