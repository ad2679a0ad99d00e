"""Hénon units of a configuration, computed by the benchmark itself.

Newton's constant and the Myr and pc conversions are the CODATA / IAU
values the configurations' physical units are defined by. In Hénon units
G = 1 and the time unit follows: t[Myr] = sqrt(L^3 / (G M)).
"""
from __future__ import annotations

import math

G_PC_KMS2_PER_MSUN = 4.300917270e-3          # pc (km/s)^2 / Msun
PC_IN_KM = 3.0856775814913673e13
MYR_IN_S = 3.15576e13
KMS_IN_PC_PER_MYR = MYR_IN_S / PC_IN_KM
G_PC_MYR_MSUN = G_PC_KMS2_PER_MSUN * KMS_IN_PC_PER_MYR ** 2


def henon(units: dict) -> tuple[float, float]:
    """(G in code units, Myr per code time unit) of a ``[units]`` table of
    kind "henon" (``mass_msun`` and ``length_pc``)."""
    if units.get("kind") != "henon":
        raise ValueError(f"the benchmark's configurations are in Hénon "
                         f"units, got {units.get('kind')!r}")
    mass, length = float(units["mass_msun"]), float(units["length_pc"])
    time_myr = math.sqrt(length ** 3 / (G_PC_MYR_MSUN * mass))
    G = G_PC_MYR_MSUN * mass * time_myr ** 2 / length ** 3
    return G, time_myr
