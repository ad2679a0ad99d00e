"""The configurations' external field, ``potential.kind = "milky_way"``:
a Hernquist (1990) bulge, a Miyamoto & Nagai (1975) disk and an NFW (1996)
halo with the masses and scales of Bovy's (2015) MWPotential-style model,
in closed form. Lengths in pc and masses in Msun are turned into code units
by the configuration's scales.
"""
from __future__ import annotations

import dataclasses

import torch

BULGE_M, BULGE_A = 5.00e9, 1.00e3             # Msun, pc
DISK_M, DISK_A, DISK_B = 6.80e10, 3.00e3, 0.28e3
HALO_MS, HALO_RS = 5.40e11, 15.62e3


@dataclasses.dataclass(frozen=True)
class MilkyWay:
    G: float
    msun: float = 1.0     # code mass units per Msun
    pc: float = 1.0       # code length units per pc

    def _params(self):
        G, m, L = self.G, self.msun, self.pc
        return (G * BULGE_M * m, BULGE_A * L, G * DISK_M * m, DISK_A * L,
                DISK_B * L, G * HALO_MS * m, HALO_RS * L)

    def phi(self, x):
        """Potential at positions x (..., 3)."""
        gmb, ab, gmd, ad, bd, gmh, rs = self._params()
        r = torch.linalg.vector_norm(x, dim=-1)
        rr = x[..., 0] ** 2 + x[..., 1] ** 2
        zb = torch.sqrt(x[..., 2] ** 2 + bd * bd)
        bulge = -gmb / (r + ab)
        disk = -gmd / torch.sqrt(rr + (ad + zb) ** 2)
        halo = -gmh * torch.log1p(r / rs) / r
        return bulge + disk + halo

    def accel(self, x):
        """-grad phi at positions x (..., 3), away from r = 0."""
        gmb, ab, gmd, ad, bd, gmh, rs = self._params()
        r = torch.linalg.vector_norm(x, dim=-1)
        zb = torch.sqrt(x[..., 2] ** 2 + bd * bd)
        dd = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + (ad + zb) ** 2)
        s = r / rs
        m_enc = torch.log1p(s) - s / (1.0 + s)
        radial = gmb / (r * (r + ab) ** 2) + gmh * m_enc / r ** 3
        k = gmd / dd ** 3
        scale = torch.stack([k, k, k * (ad + zb) / zb], dim=-1)
        return -(radial[..., None] * x + scale * x)
