"""What decides ``correct``: the window's last segment held to the plain
float64 reference (``reference/``), number by number, each against the
limit its cell's workload file sets.

The numbers, read on the segment's end state (every replayed segment ends
in the same bits, which the harness checks apart):

  accel_err   the pair acceleration the timed path left in its carry (the
              kernels' sum at the last step, the external field taken off)
              against the direct sum on the end state: the largest
              difference over the largest reference value. Under block steps
              the carry's force was evaluated at the predicted positions of
              each star's last step, so the reading holds the predictor's
              gap beside the kernels' rounding.
  jerk_err    the same for the pair jerk (block steps and shared-dt
              Hermite, whose carry's force and jerk, likewise, are those
              of the last step's prediction).
  energy_err  the row's internal energy against the reference's, over it.
  com_err     the centre of mass against the reference orbit of a point
              under the field from the set-up's centre, over the distance
              that orbit moved. Without a field the centre barely moves:
              over the reference's largest Lagrangian radius instead.
  bound_mass_err  the row's M_bound and N_bound (the iterative tidal cut)
              against the reference's: the larger relative difference.
  tidal_r_err the row's r_tidal against the reference's, relative.
  lagr_r_err  the row's Lagrangian radii of the bound stars against the
              reference's: the largest relative difference.
  core_err    the row's CH85 core radius and core density against the
              reference's: the larger relative difference. (The radius alone
              does not separate the control: a rho^2-weighted mean radius
              cancels a density error common to the stars, and the control's
              read as low as 2.6e-6 where sound runs read up to 1e-6.)
  drift       |E_tot(end) - E_tot(start)| / |E_int(start)|, all from the
              reference's energies of the program's two states: the
              integrator's error over the segment, held to the accuracy
              class the configuration states.

The control puts the reference computed in bfloat16 (sums in float32) in
the program's place: its forces, its internal energy, its row's structure
columns and its orbit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench_torch import kinds, units
from bench_torch.reference import direct, orbit, row as row_ref
from bench_torch.reference.milky_way import MilkyWay

F64 = torch.float64


@dataclasses.dataclass
class Answers:
    """What the timed path produced at a segment's end, or what the control
    or the reference puts in its place."""
    acc: torch.Tensor             # (N, 3) pair acceleration, float64
    jerk: torch.Tensor | None     # (N, 3) pair jerk (``Kind.jerk``)
    e_int: float                  # internal energy
    com: torch.Tensor             # (3,) centre of mass
    structure: dict               # the row's structure columns, as
                                  # ``reference.row.structure`` names them


@dataclasses.dataclass(frozen=True)
class Physics:
    """What the reference needs of a configuration."""
    eps: float
    G: float
    field: MilkyWay | None
    fractions: tuple          # the row's Lagrangian mass fractions
    core: bool                # the row has the CH85 columns

    @classmethod
    def of(cls, sim: dict) -> "Physics":
        G, _ = units.henon(sim["units"])
        u = sim["units"]
        kind = sim.get("potential", {}).get("kind", "none")
        if kind not in ("milky_way", "none"):
            raise ValueError(f"no reference for potential {kind!r}")
        field = (MilkyWay(G=G, msun=1.0 / float(u["mass_msun"]),
                          pc=1.0 / float(u["length_pc"]))
                 if kind == "milky_way" else None)
        out = sim.get("output", {})
        return cls(eps=float(sim["integrator"]["eps"]), G=G, field=field,
                   fractions=tuple(float(f) for f in out.get(
                       "fractions", (0.1, 0.25, 0.5, 0.75, 0.9))),
                   core=bool(out.get("core_diag", True)))


def program_answers(kind: str, phys: Physics, end, row: dict) -> Answers:
    """The timed path's answers: its carry's pair force (and jerk) and its
    row's internal energy, at the end state ``end`` (a carry)."""
    s = end.state
    acc, jerk = kinds.of(kind).pair_force(end, phys.field)
    com, _ = direct.centre_of_mass(s.pos, s.vel, s.mass)
    structure = {"M_bound": float(row["M_bound"]),
                 "N_bound": int(row["N_bound"]),
                 "r_tidal": float(row["r_tidal"]),
                 "r_lagr": [float(row[f"r_lagr_{int(round(f * 100))}"])
                            for f in phys.fractions]}
    if phys.core:
        structure["r_core"] = float(row["r_core"])
        structure["rho_core"] = float(row["rho_core"])
    return Answers(acc=acc.to(F64), jerk=jerk, e_int=float(row["E_int"]),
                   com=com, structure=structure)


def reference_answers(kind: str, phys: Physics, start, end, t: float,
                      dtype=F64, sum_dtype=None):
    """(answers, pair potential): the reference's at ``end`` (a state),
    computed in ``dtype``; the orbit starts from ``start``'s centre and
    runs for ``t``."""
    vel = end.vel if kinds.of(kind).jerk else None
    acc, phi, jerk = direct.pair_sums(end.pos, end.mass, phys.eps, phys.G,
                                      vel=vel, dtype=dtype,
                                      sum_dtype=sum_dtype)
    e = direct.energies(end.pos, end.vel, end.mass, phi)
    structure = row_ref.structure(end.pos, end.vel, end.mass, phys.field,
                                  phys.G, phys.eps, phys.fractions,
                                  core=phys.core, dtype=dtype,
                                  sum_dtype=sum_dtype, phi_pair=phi)
    return Answers(acc=acc, jerk=jerk, e_int=e["E_int"],
                   com=_orbit_com(phys, start, t, dtype),
                   structure=structure), phi


def _orbit_com(phys: Physics, start, t: float, dtype):
    x0, v0 = direct.centre_of_mass(start.pos, start.vel, start.mass)
    if phys.field is None:
        return (x0 + t * v0).cpu()
    x, _ = orbit.integrate(phys.field, x0.cpu(), v0.cpu(), t, dtype=dtype)
    return x


def drift(phys: Physics, start, end, phi_end) -> float:
    """|E_tot(end) - E_tot(start)| / |E_int(start)| from the reference's
    float64 energies of the two states (``phi_end``: the reference's pair
    potential at ``end``)."""
    e = []
    for s, phi in ((start, None), (end, phi_end)):
        if phi is None:
            _, phi, _ = direct.pair_sums(s.pos, s.mass, phys.eps, phys.G)
        phi_ext = (phys.field.phi(s.pos.to(F64)) if phys.field is not None
                   else None)
        e.append(direct.energies(s.pos, s.vel, s.mass, phi, phi_ext))
    return abs(e[1]["E_tot"] - e[0]["E_tot"]) / abs(e[0]["E_int"])


def numbers(got: Answers, ref: Answers, com0, field: bool = True) -> dict:
    """The compared numbers of ``got`` against ``ref`` (drift apart);
    ``field``: the cluster orbits in an external field."""
    out = {"accel_err": _rel_max(got.acc, ref.acc)}
    if got.jerk is not None and ref.jerk is not None:
        out["jerk_err"] = _rel_max(got.jerk, ref.jerk)
    out["energy_err"] = abs(got.e_int - ref.e_int) / abs(ref.e_int)
    g, r = got.structure, ref.structure
    if field:
        scale = float(torch.linalg.vector_norm(ref.com.cpu() - com0.cpu()))
    else:
        scale = max(r["r_lagr"])
    out["com_err"] = float(torch.linalg.vector_norm(
        got.com.cpu() - ref.com.cpu())) / scale
    out["bound_mass_err"] = max(_rel(g["M_bound"], r["M_bound"]),
                                _rel(g["N_bound"], r["N_bound"]))
    out["tidal_r_err"] = _rel(g["r_tidal"], r["r_tidal"])
    out["lagr_r_err"] = max(_rel(a, b) for a, b in zip(g["r_lagr"],
                                                        r["r_lagr"]))
    if "r_core" in r:
        out["core_err"] = max(_rel(g["r_core"], r["r_core"]),
                              _rel(g["rho_core"], r["rho_core"]))
    return out


def _rel(got: float, ref: float) -> float:
    """|got - ref| / |ref|; 0 where both are the same infinity, and NaN or
    infinity (which fail every limit) where only one is finite, either is
    NaN or the reference is 0."""
    if got == ref:
        return 0.0
    if ref == 0:
        return math.inf
    return abs(got - ref) / abs(ref)


def _rel_max(got, ref) -> float:
    diff = torch.linalg.vector_norm(got.to(ref.device) - ref, dim=-1)
    return float(diff.max() / torch.linalg.vector_norm(ref, dim=-1).max())


def readings(kind: str, phys: Physics, start, end, row: dict, t: float,
             control: bool = False) -> dict:
    """Every compared number of one segment's end: the program's readings,
    or with ``control`` the control's in the program's place."""
    ref, phi = reference_answers(kind, phys, start, end.state, t)
    if control:
        got, _ = reference_answers(kind, phys, start, end.state, t,
                                   dtype=torch.bfloat16,
                                   sum_dtype=torch.float32)
    else:
        got = program_answers(kind, phys, end, row)
    com0, _ = direct.centre_of_mass(start.pos, start.vel, start.mass)
    out = numbers(got, ref, com0, field=phys.field is not None)
    if not control:     # the program's states, whoever gives the answers
        out["drift"] = drift(phys, start, end.state, phi)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """(every value within its limit, [(name, value, limit)]). A number the
    limits do not name is refused: a cell states a limit for each."""
    rows, ok = [], True
    for name, value in values.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the cell's workload "
                           "file")
        lim = float(limits[name])
        good = value == value and value <= lim
        ok &= good
        rows.append((name, value, lim))
    return ok, rows
