"""Unit systems: Hénon N-body units (G=1) <-> physical units (pc, Myr, Msun).

Self-contained constants (no astropy dependency; SURVEY.md §6). A copy of
``oc_nbody_tpu/utils/units.py``, which imports no JAX. Capability
parity: SURVEY.md §2.1 — the reference's
"wall-clock per simulated Myr" metric (BASELINE.json:2) implies a
physical-unit API on top of internal simulation units.
"""
from __future__ import annotations

import dataclasses
import math

# Newton's constant in pc (km/s)^2 / Msun  (CODATA G with IAU pc/Msun).
G_PC_KMS2_PER_MSUN = 4.300917270e-3
# 1 km/s expressed in pc/Myr:  (1e3 m/s) * (1 Myr / 1 pc)
_PC_IN_KM = 3.0856775814913673e13
_MYR_IN_S = 3.15576e13
KMS_IN_PC_PER_MYR = _MYR_IN_S / _PC_IN_KM  # ≈ 1.0227121650537077
# G in pc^3 / (Msun Myr^2)
G_PC_MYR_MSUN = G_PC_KMS2_PER_MSUN * KMS_IN_PC_PER_MYR**2  # ≈ 4.498502e-3


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Conversion between code units and physical units.

    A unit system is fixed by the physical size of the code's length, mass
    and time units. ``G`` returns Newton's constant in code units; Hénon
    systems have G == 1 by construction.
    """

    length_pc: float   # pc per code length unit
    mass_msun: float   # Msun per code mass unit
    time_myr: float    # Myr per code time unit

    # ---- constructors -------------------------------------------------
    @classmethod
    def henon(cls, mass_msun: float, length_pc: float) -> "UnitSystem":
        """Hénon units: G=1, total cluster mass = 1, virial radius = 1.

        The time unit follows from G=1:
        t_code[Myr] = sqrt(L^3 / (G_phys * M)).
        """
        time_myr = math.sqrt(length_pc**3 / (G_PC_MYR_MSUN * mass_msun))
        return cls(length_pc=length_pc, mass_msun=mass_msun, time_myr=time_myr)

    @classmethod
    def physical(cls) -> "UnitSystem":
        """pc / Msun / Myr units; G = G_PC_MYR_MSUN ≈ 4.4985e-3."""
        return cls(length_pc=1.0, mass_msun=1.0, time_myr=1.0)

    # ---- derived ------------------------------------------------------
    @property
    def G(self) -> float:
        """Newton's constant in code units."""
        return G_PC_MYR_MSUN * self.mass_msun * self.time_myr**2 / self.length_pc**3

    @property
    def velocity_kms(self) -> float:
        """km/s per code velocity unit."""
        return (self.length_pc / self.time_myr) / KMS_IN_PC_PER_MYR

    @property
    def velocity_pc_myr(self) -> float:
        return self.length_pc / self.time_myr

    @property
    def energy_msun_kms2(self) -> float:
        """Msun (km/s)^2 per code energy unit (mass * velocity^2)."""
        return self.mass_msun * self.velocity_kms**2

    # ---- conversions --------------------------------------------------
    def to_physical(self, value, kind: str):
        return value * self._factor(kind)

    def to_code(self, value, kind: str):
        return value / self._factor(kind)

    def _factor(self, kind: str) -> float:
        factors = {
            "length": self.length_pc,
            "mass": self.mass_msun,
            "time": self.time_myr,
            "velocity": self.velocity_kms,
            "energy": self.energy_msun_kms2,
        }
        if kind not in factors:
            raise ValueError(f"unknown quantity kind {kind!r}; one of {sorted(factors)}")
        return factors[kind]

    def as_dict(self) -> dict:
        return {
            "length_pc": self.length_pc,
            "mass_msun": self.mass_msun,
            "time_myr": self.time_myr,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "UnitSystem":
        return cls(length_pc=float(d["length_pc"]),
                   mass_msun=float(d["mass_msun"]),
                   time_myr=float(d["time_myr"]))
