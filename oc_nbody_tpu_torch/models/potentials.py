"""Analytic external potentials in PyTorch: the static subset of
``oc_nbody_tpu/models/potentials.py`` — Hernquist bulge, Miyamoto–Nagai
disk, NFW halo, their composite and the three-component Milky Way.

Each potential is a frozen dataclass of Python-float parameters, so it
evaluates on whatever device and dtype its positions have. Φ and the
accelerations are hand-written closed forms (O(N) per force evaluation).
The derived quantities of the base class — dΦ/dR, v_circ, the tidal tensor,
the external jerk (v·∇)a — come from autodiff (``torch.func``), exact with
no finite differencing, in place of ``jax.grad`` / ``jax.hessian`` /
``jax.jvp``. The three Milky Way components override the jerk with its
closed form: the same derivative in a tenth of the operations, since a
block-timestep micro-step evaluates it once for every particle and the
step is bound by launching small operations.

All quantities are in code units: G is passed at construction (scene.py
converts physical parameters with a UnitSystem). The time-dependent
fields (MovingCenter, Rotating, Ramped, bars, perturbers, gas) are not
ported yet (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

_F64 = torch.float64


def _r(xyz):
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1))


def _tiny(xyz):
    return torch.finfo(xyz.dtype).tiny


@dataclasses.dataclass(frozen=True)
class Potential:
    """Base class. Subclasses implement phi(xyz) and accel(xyz).

    xyz has shape (..., 3); phi returns (...,); accel returns (..., 3).
    """

    def phi(self, xyz):
        raise NotImplementedError

    def accel(self, xyz):
        raise NotImplementedError

    # ---- generic derived quantities (autodiff of phi, f64) ------------
    def phi_R(self, R):
        """Φ in the z=0 midplane as a function of cylindrical radius."""
        R = torch.as_tensor(R, dtype=_F64)
        zero = torch.zeros_like(R)
        return self.phi(torch.stack([R, zero, zero], dim=-1))

    def dphi_dR(self, R):
        R = torch.as_tensor(R, dtype=_F64)
        return torch.vmap(torch.func.grad(self.phi_R))(R.reshape(-1)) \
            .reshape(R.shape)

    def vcirc(self, R):
        """Circular speed at midplane radius R: v_c^2 = R dΦ/dR."""
        R = torch.as_tensor(R, dtype=_F64)
        return torch.sqrt(torch.clamp(R * self.dphi_dR(R), min=0.0))

    def omega2(self, R):
        """Squared circular angular frequency Ω² = v_c²/R²."""
        R = torch.as_tensor(R, dtype=_F64)
        return self.dphi_dR(R) / R

    def tidal_tensor(self, xyz):
        """T_ij = −∂²Φ/∂x_i∂x_j at a single point; (3, 3), symmetric.

        Exact autodiff Hessian in f64. The largest eigenvalue is the
        maximal tidal stretching rate²; for a point-mass host it is 2GM/r³
        along the radial direction."""
        xyz = torch.as_tensor(xyz, dtype=_F64)
        return -torch.func.hessian(self.phi)(xyz)

    def accel_jerk_ext(self, pos, vel):
        """(a_ext, da_ext/dt) along a trajectory: the exact convective
        derivative (v·∇)a via one forward-mode jvp of ``accel``. Only
        static fields are ported, so there is no ∂a/∂t term."""
        return torch.func.jvp(self.accel, (pos,), (vel,))

    def tidal_coefficient_at(self, xyz, omega2):
        """λ_max(T) + Ω²: the tidal-radius denominator at a position.

        ``omega2`` is the squared instantaneous angular speed of the
        cluster's orbit about the host, |r × v|²/r⁴. On a circular midplane
        orbit this reduces to Ω² − ∂²Φ/∂R² (3GM/r³ for a spherical host)."""
        return torch.linalg.eigvalsh(self.tidal_tensor(xyz))[-1] + omega2


@dataclasses.dataclass(frozen=True)
class Hernquist(Potential):
    """Hernquist (1990) sphere: Φ = −GM/(r+a)."""

    GM: float
    a: float

    def phi(self, xyz):
        return -self.GM / (_r(xyz) + self.a)

    def accel(self, xyz):
        r = _r(xyz)
        safe_r = torch.clamp(r, min=_tiny(xyz))
        mag = torch.where(r > 0, self.GM / (r + self.a) ** 2 / safe_r, 0.0)
        return -mag[..., None] * xyz

    def accel_jerk_ext(self, pos, vel):
        """a = -g x with g = GM/((r+a)² r); (v·∇)a = -g v + g (2/(r+a) +
        1/r) (x·v)/r x. Zero at r = 0, as the accel is."""
        r = _r(pos)
        safe_r = torch.clamp(r, min=_tiny(pos))
        g = torch.where(r > 0, self.GM / (r + self.a) ** 2 / safe_r, 0.0)
        k = g * (2.0 / (r + self.a) + 1.0 / safe_r) * (
            torch.sum(pos * vel, dim=-1) / safe_r)
        return -g[..., None] * pos, k[..., None] * pos - g[..., None] * vel


@dataclasses.dataclass(frozen=True)
class MiyamotoNagai(Potential):
    """Miyamoto–Nagai (1975) disk: Φ = −GM / sqrt(R² + (a + sqrt(z²+b²))²)."""

    GM: float
    a: float
    b: float

    def _parts(self, xyz):
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        zb = torch.sqrt(z * z + self.b * self.b)
        s = self.a + zb
        denom = torch.sqrt(x * x + y * y + s * s)
        return x, y, z, zb, s, denom

    def phi(self, xyz):
        *_, denom = self._parts(xyz)
        return -self.GM / denom

    def accel(self, xyz):
        x, y, z, zb, s, denom = self._parts(xyz)
        inv_d3 = self.GM / denom**3
        az = -inv_d3 * z * s / torch.clamp(zb, min=_tiny(xyz))
        return torch.stack([-inv_d3 * x, -inv_d3 * y, az], dim=-1)

    def accel_jerk_ext(self, pos, vel):
        """With K = GM/D³ and q = s/zb: a = -K (x, y, z q); dK/dt = -3 K w,
        w = (x vx + y vy + q z vz)/D²; d(z q)/dt = vz (1 + a b²/zb³)."""
        x, y, z, zb, s, denom = self._parts(pos)
        vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
        K = self.GM / denom**3
        zb_safe = torch.clamp(zb, min=_tiny(pos))
        q = s / zb_safe
        w3 = 3.0 * (x * vx + y * vy + q * z * vz) / (denom * denom)
        acc = torch.stack([-K * x, -K * y, -K * z * q], dim=-1)
        dzq = vz * (1.0 + self.a * self.b * self.b / zb_safe**3)
        jerk = K[..., None] * torch.stack(
            [w3 * x - vx, w3 * y - vy, w3 * z * q - dzq], dim=-1)
        return acc, jerk


@dataclasses.dataclass(frozen=True)
class NFW(Potential):
    """NFW (1996) halo: Φ = −G M_s ln(1 + r/r_s) / r, M_s = 4πρ₀r_s³."""

    GMs: float
    rs: float

    def phi(self, xyz):
        r = _r(xyz)
        safe_r = torch.clamp(r, min=_tiny(xyz))
        # limit r -> 0: -GMs/rs
        return torch.where(r > 0, -self.GMs * torch.log1p(r / self.rs) / safe_r,
                           -self.GMs / self.rs)

    def accel(self, xyz):
        r = _r(xyz)
        safe_r = torch.clamp(r, min=_tiny(xyz))
        x = r / self.rs
        menc = torch.log1p(x) - x / (1.0 + x)  # M(<r)/M_s
        # stepwise divisions: r == 0 gives 0/tiny = 0 (tiny**3 would underflow)
        mag = torch.where(r > 0, ((self.GMs * menc / safe_r) / safe_r) / safe_r,
                          0.0)
        return -mag[..., None] * xyz

    def accel_jerk_ext(self, pos, vel):
        """a = -g x with g = GMs m(r)/r³, dm/dr = r/(rs+r)²; (v·∇)a = -g v
        - (GMs/((rs+r)² r³) - 3g/r²) (x·v) x. Zero at r = 0."""
        r = _r(pos)
        safe_r = torch.clamp(r, min=_tiny(pos))
        x = r / self.rs
        menc = torch.log1p(x) - x / (1.0 + x)
        g = torch.where(r > 0, ((self.GMs * menc / safe_r) / safe_r) / safe_r,
                        0.0)
        dg = torch.where(
            r > 0, self.GMs / ((self.rs + r) ** 2 * safe_r**3)
            - 3.0 * g / (safe_r * safe_r), 0.0)
        k = dg * torch.sum(pos * vel, dim=-1)
        return -g[..., None] * pos, -k[..., None] * pos - g[..., None] * vel


@dataclasses.dataclass(frozen=True)
class Composite(Potential):
    components: tuple

    def phi(self, xyz):
        return sum(c.phi(xyz) for c in self.components)

    def accel(self, xyz):
        return sum(c.accel(xyz) for c in self.components)

    def accel_jerk_ext(self, pos, vel):
        """Sum of the members' (a, da/dt) pairs, as in the JAX package
        (there each member handles its own ∂a/∂t)."""
        acc = torch.zeros_like(pos)
        jerk = torch.zeros_like(pos)
        for c in self.components:
            a, j = c.accel_jerk_ext(pos, vel)
            acc = acc + a
            jerk = jerk + j
        return acc, jerk


def composite(components: Sequence[Potential]) -> Composite:
    return Composite(components=tuple(components))


# -- Milky Way defaults (physical: pc, Msun, Myr) ---------------------------
# Bovy (2015) / gala MilkyWayPotential-style 3-component model; the same
# constants as oc_nbody_tpu/models/potentials.py.
MW_BULGE_M = 5.00e9       # Msun
MW_BULGE_A = 1.00e3       # pc
MW_DISK_M = 6.80e10       # Msun
MW_DISK_A = 3.00e3        # pc
MW_DISK_B = 0.28e3        # pc
MW_HALO_MS = 5.40e11      # Msun
MW_HALO_RS = 15.62e3      # pc


def milky_way(G: float, mass_scale: float = 1.0,
              length_scale: float = 1.0) -> Composite:
    """Three-component Milky Way in code units.

    Args:
      G: gravitational constant in code units.
      mass_scale: code mass units per Msun (i.e. multiply Msun values by this).
      length_scale: code length units per pc.
    """
    m, L = mass_scale, length_scale
    return composite([
        Hernquist(GM=G * MW_BULGE_M * m, a=MW_BULGE_A * L),
        MiyamotoNagai(GM=G * MW_DISK_M * m, a=MW_DISK_A * L, b=MW_DISK_B * L),
        NFW(GMs=G * MW_HALO_MS * m, rs=MW_HALO_RS * L),
    ])
