"""ForceModel: pairwise self-gravity plus the static external field.

Counterpart of ``oc_nbody_tpu/forces.py`` on its friction-free path, at
the f32, the extended (hi/lo) and the two-float (df32) precision tiers, and
escape-pruned (``with_sources``) at the f32 and the extended tier. The pairwise sum goes through ``ops.cuda_gravity`` and
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

Escape pruning (``oc_nbody_tpu/escape.py``; the JAX package's
forces.py:83-324, :717-760). ``with_sources`` returns a model whose
pairwise SOURCES are the gathered cluster bucket ``pos[src_idx]`` with
masses ``mass[src_idx] * src_wgt``; every star stays a target. Each
evaluation is two sweeps, combined by a scatter at ``src_idx``:
  sweep 1: ALL rows x the bucket           (the tail rows' final force)
  sweep 2: the bucket's rows x ALL sources (the cluster rows' final force)
so only tail–tail pairs are dropped, and the reduced system is a genuine
Hamiltonian. The padding of the bucket repeats its first member with zero
weight: its sweep-2 rows duplicate that member's row, and the kernels give a
row the same bits whatever other rows share the launch, so the duplicate
writes of the scatter are equal. At the f32 tier both sweeps centre on the
bucket's mean in f64 and cast to f32; at the extended tier rows and bucket
are split under ONE f64 centre (the bucket's mean) and gm = G·m is rounded
from f64. The cluster rows' potential holds the softened self term (they
are sweep 2's sources) and has it cancelled: at f32 with ``self_phi`` of
the f32 masses, at the extended tier of gm with G = 1, both in f32 as in the
JAX package; the tail rows' is clean. ``diagnostics.energies``' uniform ½
weight then sums the mixed potential to the reduced pair energy PE_CC +
PE_CT. Sweep 2 past 262,144 sources takes K18<comp>, and both sweeps at
the extended tier past its caps K19 (``ops/cuda_gravity.py``).
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
    stepper's active rows).

    ``src_idx`` (B,) int64, ``src_wgt`` (B,) and ``src_mask`` (N,), device
    tensors, are the escape-pruning partition (``with_sources``): the
    bucket's particle indices, 1.0 for a member and 0.0 for padding, and
    1.0 for a cluster member among all N (0.0 for a tail star). None when
    the model is not pruned."""

    eps: float
    G: float
    external: Optional[Potential] = None
    softened: bool = False
    precision: str = "f32"
    src_idx: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        compare=False)
    src_wgt: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        compare=False)
    src_mask: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         compare=False)

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

    # ---- escape pruning ------------------------------------------------
    @property
    def pruned(self) -> bool:
        return self.src_idx is not None

    def with_sources(self, src_idx, src_wgt, src_mask) -> "ForceModel":
        """A copy whose pairwise sources are the pruned bucket (escape
        pruning): ``src_idx`` the bucket's indices (any integer dtype; kept
        as int64), ``src_wgt`` 1.0 for members and 0.0 for padding,
        ``src_mask`` 1.0 for the cluster's members among all N. The f32 and
        the extended tier only; df32 is refused, as in the JAX package."""
        if self.precision not in ("f32", "extended"):
            raise ValueError(
                "escape pruning supports the f32 and extended tiers only "
                f"(got precision={self.precision!r})")
        return dataclasses.replace(
            self, src_idx=torch.as_tensor(src_idx).to(torch.int64),
            src_wgt=torch.as_tensor(src_wgt),
            src_mask=torch.as_tensor(src_mask))

    def unpruned(self) -> "ForceModel":
        """This model without the pruned partition."""
        return dataclasses.replace(self, src_idx=None, src_wgt=None,
                                   src_mask=None)

    def _gathered_sources(self, pos, mass, vel=None):
        """(src_pos, src_mass, src_vel) of the pruned bucket."""
        idx = self.src_idx
        sm = mass[idx] * self.src_wgt.to(mass.dtype)
        return pos[idx], sm, (vel[idx] if vel is not None else None)

    def _pruned_prep(self, pos, mass, vel=None):
        """Centred f32 operands of both f32 sweeps, centred on the bucket's
        mean: (rows_c, bucket_c, bucket_mass, all_mass, vrows_c,
        vbucket_c), the last two None without ``vel``."""
        sp, sm, sv = self._gathered_sources(pos, mass, vel=vel)
        f32 = torch.float32
        center = torch.mean(sp, dim=0)
        out = ((pos - center).to(f32).contiguous(),
               (sp - center).to(f32).contiguous(), sm.to(f32).contiguous(),
               mass.to(f32).contiguous())
        if vel is None:
            return (*out, None, None)
        vcenter = torch.mean(sv, dim=0)
        return (*out, (vel - vcenter).to(f32).contiguous(),
                (sv - vcenter).to(f32).contiguous())

    def _pruned_prep_x(self, pos, mass, vel=None):
        """(hi, lo) f32 planes of the rows and of the bucket under ONE f64
        centre (the bucket's mean; both sweeps' hi planes must live in one
        frame), gm = G·m rounded from f64 for the bucket and for all:
        (rhi, rlo, bhi, blo, gm_b, gm_all, vel_planes), vel_planes
        ((vrhi, vrlo), (vbhi, vblo)) or None."""
        sp, sm, sv = self._gathered_sources(pos, mass, vel=vel)
        f64 = torch.float64
        center = torch.mean(sp.to(f64), dim=0)
        rhi, rlo = gravity.split_hilo(pos.to(f64) - center)
        bhi, blo = gravity.split_hilo(sp.to(f64) - center)
        gm_b = gravity.gm_f32(sm, self.G)
        gm_all = gravity.gm_f32(mass, self.G)
        if vel is None:
            return rhi, rlo, bhi, blo, gm_b, gm_all, None
        vcenter = torch.mean(sv.to(f64), dim=0)
        return (rhi, rlo, bhi, blo, gm_b, gm_all,
                (gravity.split_hilo(vel.to(f64) - vcenter),
                 gravity.split_hilo(sv.to(f64) - vcenter)))

    def _pair_accel_pruned(self, pos, mass):
        g = not self.softened
        if self._extended:
            rhi, rlo, bhi, blo, gm_b, gm_all, _ = self._pruned_prep_x(pos,
                                                                      mass)
            a_tail = cuda_gravity.accel_rows_x_hilo(rhi, rlo, bhi, blo, gm_b,
                                                    self.eps, g)
            a_cl = cuda_gravity.accel_rows_x_hilo(bhi, blo, rhi, rlo, gm_all,
                                                  self.eps, g)
        else:
            rows_c, bucket_c, bmass, amass, _, _ = self._pruned_prep(pos,
                                                                     mass)
            a_tail = cuda_gravity.accel_rows(rows_c, bucket_c, bmass,
                                             self.eps, self.G, 0, g)
            a_cl = cuda_gravity.accel_rows(bucket_c, rows_c, amass, self.eps,
                                           self.G, 0, g)
        return a_tail.index_copy(0, self.src_idx, a_cl).to(pos.dtype)

    def _pair_accel_potential_pruned(self, pos, mass):
        g = not self.softened
        idx = self.src_idx
        if self._extended:
            rhi, rlo, bhi, blo, gm_b, gm_all, _ = self._pruned_prep_x(pos,
                                                                      mass)
            a_tail, p_tail = cuda_gravity.accel_potential_rows_x_hilo(
                rhi, rlo, bhi, blo, gm_b, self.eps, g)
            a_cl, p_cl = cuda_gravity.accel_potential_rows_x_hilo(
                bhi, blo, rhi, rlo, gm_all, self.eps, g)
            # the cluster rows are sweep 2's sources: cancel their softened
            # self term (gm = G·m, so self_phi with G = 1 gives G m/eps)
            p_cl = p_cl + gravity.self_phi(gm_all[idx], self.eps, 1.0)
        else:
            rows_c, bucket_c, bmass, amass, _, _ = self._pruned_prep(pos,
                                                                     mass)
            a_tail, p_tail = cuda_gravity.accel_potential_rows(
                rows_c, bucket_c, bmass, self.eps, self.G, 0, g)
            a_cl, p_cl = cuda_gravity.accel_potential_rows(
                bucket_c, rows_c, amass, self.eps, self.G, 0, g)
            p_cl = p_cl + gravity.self_phi(
                amass[idx], self.eps, gravity.rounded(self.G, torch.float32))
        return (a_tail.index_copy(0, idx, a_cl).to(pos.dtype),
                p_tail.index_copy(0, idx, p_cl).to(pos.dtype))

    def _pair_accel_jerk_pruned(self, pos, vel, mass):
        g = not self.softened
        if self._extended:
            rhi, rlo, bhi, blo, gm_b, gm_all, v = self._pruned_prep_x(
                pos, mass, vel=vel)
            (vrhi, vrlo), (vbhi, vblo) = v
            a_tail, j_tail = cuda_gravity.accel_jerk_rows_x_hilo(
                rhi, rlo, vrhi, vrlo, bhi, blo, vbhi, vblo, gm_b, self.eps, g)
            a_cl, j_cl = cuda_gravity.accel_jerk_rows_x_hilo(
                bhi, blo, vbhi, vblo, rhi, rlo, vrhi, vrlo, gm_all, self.eps,
                g)
        else:
            (rows_c, bucket_c, bmass, amass, vrows_c,
             vbucket_c) = self._pruned_prep(pos, mass, vel=vel)
            a_tail, j_tail = cuda_gravity.accel_jerk_rows(
                rows_c, vrows_c, bucket_c, vbucket_c, bmass, self.eps, self.G,
                0, g)
            a_cl, j_cl = cuda_gravity.accel_jerk_rows(
                bucket_c, vbucket_c, rows_c, vrows_c, amass, self.eps, self.G,
                0, g)
        idx = self.src_idx
        return (a_tail.index_copy(0, idx, a_cl).to(pos.dtype),
                j_tail.index_copy(0, idx, j_cl).to(pos.dtype))

    def pruned_row_sources(self, pos, vel, mass):
        """The block stepper's tail-row operands: (rows, bucket), every
        particle's planes centred (and split) in the pruned bucket's frame
        as ``accel_jerk_on_rows`` centres its rows, and the bucket as
        ``centred_sources`` gives it, without the two centres."""
        sp, sm, sv = self._gathered_sources(pos, mass, vel=vel)
        *bucket, center, vcenter = self.centred_sources(sp, sv, sm)
        return self.centred_rows(pos, vel, center, vcenter), tuple(bucket)

    # ---- the public evaluations ----------------------------------------
    def accel(self, pos, mass):
        """Total acceleration, pairwise + external; (N, 3) in pos.dtype."""
        if self.pruned:
            acc = self._pair_accel_pruned(pos, mass)
        else:
            fn = {"f32": cuda_gravity.accel,
                  "extended": cuda_gravity.accel_x,
                  "df32": cuda_df.accel_df}[self.precision]
            acc = fn(pos, mass, self.eps, self.G, guarded=not self.softened)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def accel_jerk(self, pos, vel, mass):
        """(accel, jerk), pairwise + external, in pos.dtype; the external
        jerk is the field's exact convective derivative (v·∇)a_ext."""
        if self.pruned:
            acc, jerk = self._pair_accel_jerk_pruned(pos, vel, mass)
        else:
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

    def centred_rows(self, pos_rows, vel_rows, center, vcenter):
        """Rows as the pair kernels take them against sources that
        ``centred_sources`` centred on (center, vcenter): centred in f64
        and cast to f32, or at the extended tier centred and split into
        (rhi, rlo, vhi, vlo); at the df32 tier the rows in f64."""
        if self._df32:
            f64 = torch.float64
            return (pos_rows.to(f64), vel_rows.to(f64))
        if self._extended:
            return cuda_gravity.split_rows_x(pos_rows, vel_rows, center,
                                             vcenter)
        f32 = torch.float32
        return ((pos_rows - center).to(f32).contiguous(),
                (vel_rows - vcenter).to(f32).contiguous())

    def accel_jerk_on_rows(self, pos_rows, vel_rows, src_pos, src_vel,
                           src_mass, rows_mask=None):
        """(accel, jerk) on a row subset against the full source set, in
        pos_rows.dtype: the block-timestep active-set evaluation. Rows and
        sources are centred on the unweighted source mean in f64 before the
        f32 cast (or the hi/lo split); the external field acts on the raw
        row positions.

        Escape pruning: ``rows_mask`` (1 = cluster member, 0 = tail; values
        between mark don't-care fill rows) picks per row between the
        cluster rows' evaluation against ALL sources and the tail rows'
        against the bucket (centred on the bucket's mean). As in the JAX
        package, all-cluster rows pay rows x N, all-tail rows rows x B, and
        only mixed rows pay both (one host read of two flags chooses). An
        unpruned model ignores ``rows_mask``."""
        if self.pruned:
            if rows_mask is None:
                raise ValueError(
                    "pruned accel_jerk_on_rows needs rows_mask (the rows' "
                    "cluster membership)")
            base = self.unpruned()
            any_tail, any_cl = torch.stack(
                [torch.any(rows_mask == 0.0), torch.any(rows_mask == 1.0)]
            ).tolist()
            out = []
            if any_cl or not any_tail:
                out.append(base.accel_jerk_on_rows(pos_rows, vel_rows,
                                                   src_pos, src_vel,
                                                   src_mass))
            if any_tail:
                sp, sm, sv = self._gathered_sources(
                    src_pos, torch.as_tensor(src_mass), vel=src_vel)
                out.append(base.accel_jerk_on_rows(pos_rows, vel_rows, sp,
                                                   sv, sm))
            if len(out) == 1:
                return out[0]
            mb = (rows_mask >= 0.5)[:, None]
            return (torch.where(mb, out[0][0], out[1][0]),
                    torch.where(mb, out[0][1], out[1][1]))
        *sources, center, vcenter = self.centred_sources(src_pos, src_vel,
                                                         src_mass)
        rows = self.centred_rows(pos_rows, vel_rows, center, vcenter)
        acc, jerk = self.pair_accel_jerk_rows(*rows, *sources)
        acc = acc.to(pos_rows.dtype)
        jerk = jerk.to(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk

    def accel_potential(self, pos, mass):
        """(accel, phi_pair, phi_ext); potentials are per-particle. Under
        pruning phi_pair is the mixed potential of the reduced system (the
        cluster rows' from all sources, the tail rows' from the bucket)."""
        if self.pruned:
            acc, phi_pair = self._pair_accel_potential_pruned(pos, mass)
        elif self._df32:
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
