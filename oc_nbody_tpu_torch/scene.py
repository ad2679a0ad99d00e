"""Scene building: units, the external field, the IC and its orbit.

Counterpart of ``oc_nbody_tpu/scene.py`` for the slices the port runs: a
Plummer or King cluster with equal, Kroupa or Salpeter masses and
optionally a primordial binary population, isolated or on a circular or
eccentric (optionally inclined) orbit in the analytic Milky Way,
integrated with fixed-dt KDK, shared-dt Hermite-4 or block timesteps on one
device, at the f32, the extended (hi/lo) or the two-float (df32) pairwise
precision tier, optionally with escape pruning (``escape.prune``, the f32
and extended tiers; run.py); or, at the f32 tier under KDK and Hermite, on
a mesh of several shards (``parallel/``: ``mesh.n_devices`` resolves to
the visible devices, 0 to all of them; an API caller may pass its own
``Mesh``). Every other config value is refused
with the ROADMAP item that ports it, so a config never runs as something it
does not say.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from oc_nbody_tpu_torch.config import SimConfig
from oc_nbody_tpu_torch.forces import (ForceModel, check_precision,
                                       make_force_model)
from oc_nbody_tpu_torch.integrators.block import BlockHermite
from oc_nbody_tpu_torch.integrators.hermite import Hermite4
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.models import imf as imf_mod
from oc_nbody_tpu_torch.models import potentials as pot_mod
from oc_nbody_tpu_torch.models.binaries import (BinaryPopulation,
                                                 add_binaries)
from oc_nbody_tpu_torch.models.king import king
from oc_nbody_tpu_torch.models.plummer import plummer
from oc_nbody_tpu_torch.ops import cuda_gravity
from oc_nbody_tpu_torch.parallel.force import (ShardedForce, check_sharded,
                                               make_sharded_force)
from oc_nbody_tpu_torch.parallel.mesh import Mesh, make_mesh
from oc_nbody_tpu_torch.state import ParticleState
from oc_nbody_tpu_torch.utils.units import UnitSystem

# (config path, the only value the port runs, ROADMAP item that ports the
# others)
_UNPORTED = (
    ("integrator.macro_batches", 0, "A18 (macro steppers)"),
    ("integrator.pair_dt", False, "A11 (pair_dt: the encounter sweep)"),
    ("potential.perturber.kind", "none", "A14 (time-dependent fields)"),
    ("potential.bar.kind", "none", "A14 (time-dependent fields)"),
    ("potential.gas.kind", "none", "A14 (time-dependent fields)"),
    ("friction.kind", "none", "A14 (dynamical friction)"),
    ("sev.kind", "none", "A14 (stellar evolution)"),
    ("ic.vel_scale", 1.0, "A8 (scene options)"),
    ("ic.rotation", 0.0, "A14 (models/rotation.py)"),
    ("ic.segregation", 0.0, "A14 (models/segregation.py)"),
)
_IC_ITEMS = {"dehnen": "A14", "eff": "A14", "file": "A3 (snapshot I/O)"}
_INTEGRATOR_ITEMS = {"yoshida4": "A14"}
# the IMF and the binaries draw from their own generators, so an IC's
# stream is the same whatever the IMF and the binary fraction
_IMF_STREAM = 0x494D46
_BINARY_STREAM = 0x42494E
_POTENTIAL_ITEMS = {"point_mass": "A4", "log_halo": "A4"}


@dataclasses.dataclass
class Scene:
    units: UnitSystem
    state: ParticleState
    force: ForceModel | ShardedForce
    config: SimConfig


def _get(cfg, path: str):
    obj = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def resolve_mesh(cfg: SimConfig, device,
                 mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The run's mesh: ``mesh`` when an API caller gives one (for example
    ``Mesh.on_one_device``), else ``mesh.n_devices`` resolved against the
    visible devices of ``device``'s type (0: all of them; more than are
    visible: ValueError). None when that is one shard: the run builds the
    unsharded ForceModel, as the JAX package does."""
    if mesh is None:
        if cfg.mesh.n_devices == 1:
            return None
        mesh = make_mesh(cfg.mesh.n_devices, device)
    return mesh if mesh.n_devices > 1 else None


def mesh_mode(cfg: SimConfig) -> str:
    """The sharded-force mode: ``auto`` is ``allgather``."""
    return "allgather" if cfg.mesh.mode == "auto" else cfg.mesh.mode


def _check_sharded(cfg: SimConfig) -> None:
    """What a mesh of more than one shard runs: the f32 tier under KDK and
    Hermite, unpruned (ValueError for df32, ``rdma`` at the extended tier
    and an unknown mode, as the JAX package's ``make_sharded_force``)."""
    check_sharded(mesh_mode(cfg), cfg.integrator.precision)
    if cfg.integrator.kind == "block":
        raise NotImplementedError(
            "block steps on a mesh (the active rows against sharded "
            "sources) are not ported yet (ROADMAP A17a); the port shards "
            "KDK and Hermite")
    if cfg.escape.prune:
        raise NotImplementedError("escape pruning on a mesh is not ported "
                                  "yet (ROADMAP A17c)")


def n_particles(cfg: SimConfig) -> int:
    """The star count the config builds: ``ic.n`` systems plus one star
    for each of its ``round(ic.binary_fraction * ic.n)`` binaries
    (``add_binaries``)."""
    ic = cfg.ic
    return ic.n + (int(round(ic.binary_fraction * ic.n))
                   if ic.binary_fraction > 0.0 else 0)


# precision tier -> the ROADMAP item that runs it past STREAM_N particles
_CAPPED_TIERS = {"df32": "B10: the df32 tier past STREAM_N"}


def check_supported(cfg: SimConfig, device=None,
                    mesh: Optional[Mesh] = None) -> None:
    """Raise for a config the port cannot run as written (on ``device``,
    or on ``mesh``, when given): NotImplementedError for what is not ported
    yet, before any state or stepper is built. Without either,
    ``mesh.n_devices = 0`` is left to the run to resolve."""
    if cfg.backend != "auto":
        raise ValueError(
            f"backend = {cfg.backend!r} names a JAX backend; the port takes "
            "'auto' only (the kernel or its plain twin is chosen by the "
            "tensors' device)")
    kind = cfg.integrator.kind
    if kind in _INTEGRATOR_ITEMS:
        raise NotImplementedError(
            f"integrator.kind = {kind!r} is not ported yet (ROADMAP "
            f"{_INTEGRATOR_ITEMS[kind]}); the port runs 'kdk', 'hermite' and "
            "'block'")
    if mesh is not None or device is not None:
        mesh = resolve_mesh(cfg, device, mesh)
        shards = mesh.n_devices if mesh is not None else 1
    else:
        shards = cfg.mesh.n_devices
    if shards > 1:
        _check_sharded(cfg)
    precision = cfg.integrator.precision
    check_precision(precision)
    n = n_particles(cfg)
    if precision in _CAPPED_TIERS and n > cuda_gravity.STREAM_N:
        raise NotImplementedError(
            f"{n} particles at the {precision} precision tier: past STREAM_N "
            f"= {cuda_gravity.STREAM_N} that tier is not ported yet (ROADMAP "
            f"{_CAPPED_TIERS[precision]}); the f32 and extended tiers run "
            "any N")
    for path, value, item in _UNPORTED:
        got = _get(cfg, path)
        if got != value and not (got is None and value == "none"):
            raise NotImplementedError(
                f"{path} = {got!r} is not ported yet (ROADMAP {item}); the "
                f"port runs {path} = {value!r}")


def resolve_device(device) -> torch.device:
    """The run's device; 'cuda' without a visible card raises (no fallback
    to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch sees no "
                           "CUDA device; the port does not fall back to the "
                           "CPU (pass --device cpu to run there)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def build_units(cfg: SimConfig) -> UnitSystem:
    u = cfg.units
    if u.kind == "henon":
        return UnitSystem.henon(mass_msun=u.mass_msun, length_pc=u.length_pc)
    if u.kind == "physical":
        return UnitSystem.physical()
    raise ValueError(f"unknown units kind {u.kind!r}")


def build_external_potential(cfg: SimConfig,
                             us: UnitSystem) -> Optional[pot_mod.Potential]:
    kind = cfg.potential.kind
    if kind == "none":
        return None
    if kind == "milky_way":
        return pot_mod.milky_way(us.G, 1.0 / us.mass_msun, 1.0 / us.length_pc)
    if kind in _POTENTIAL_ITEMS:
        raise NotImplementedError(
            f"potential.kind {kind!r} is not ported yet "
            f"(ROADMAP {_POTENTIAL_ITEMS[kind]})")
    raise ValueError(f"unknown potential kind {kind!r}")


def build_singles(cfg: SimConfig, us: UnitSystem) -> ParticleState:
    """The IC's systems on the CPU: the Plummer IC (from a generator seeded
    with ``ic.seed``) or the King IC (numpy, ``ic.seed``), with IMF masses
    from a second generator when ``ic.imf`` is not ``equal``."""
    ic = cfg.ic
    if ic.kind in _IC_ITEMS:
        raise NotImplementedError(f"ic.kind {ic.kind!r} is not ported yet "
                                  f"(ROADMAP {_IC_ITEMS[ic.kind]})")
    masses = None
    if ic.imf != "equal":
        samplers = {"kroupa": imf_mod.kroupa_imf,
                    "salpeter": imf_mod.salpeter_imf}
        if ic.imf not in samplers:
            raise ValueError(f"unknown IMF {ic.imf!r}")
        gen = torch.Generator().manual_seed(ic.seed + _IMF_STREAM)
        masses = samplers[ic.imf](ic.n, gen, m_min=ic.m_min_msun,
                                  m_max=ic.m_max_msun)
    if ic.kind == "plummer":
        gen = torch.Generator().manual_seed(ic.seed)
        return plummer(ic.n, gen, a=ic.a, total_mass=ic.total_mass, G=us.G,
                       masses=masses)
    if ic.kind == "king":
        return king(ic.n, ic.w0, seed=ic.seed, total_mass=ic.total_mass,
                    G=us.G, masses=masses)
    raise ValueError(f"unknown IC kind {ic.kind!r}")


def build_binaries(cfg: SimConfig, us: UnitSystem,
                   singles: ParticleState) -> BinaryPopulation:
    """``ic.binary_fraction`` of ``singles`` split into binaries, from a
    third generator (seed + a constant): the state and which particles
    pair up. Comes after the JAX package's rotation and segregation steps,
    which are not ported."""
    ic = cfg.ic
    if not ic.binary_fraction > 0.0:
        return add_binaries(singles, None, 0.0, 1.0, 1.0)    # no pairs
    if ic.binary_a_min is None or ic.binary_a_max is None:
        raise ValueError(
            "ic.binary_fraction > 0 requires ic.binary_a_min and "
            "ic.binary_a_max (semi-major-axis bounds, code units)")
    if ic.binary_a_min < 2.0 * cfg.integrator.eps:
        raise ValueError(
            f"ic.binary_a_min = {ic.binary_a_min} is below twice the "
            f"softening eps = {cfg.integrator.eps}: such pairs are "
            "softened away, not binaries — raise a_min or lower eps")
    gen = torch.Generator().manual_seed(ic.seed + _BINARY_STREAM)
    return add_binaries(
        singles, gen, fraction=ic.binary_fraction, a_min=ic.binary_a_min,
        a_max=ic.binary_a_max, G=us.G, q_min=ic.binary_q_min,
        e_max=ic.binary_e_max)


def build_ic(cfg: SimConfig, us: UnitSystem, device) -> ParticleState:
    """The configured IC: the systems, then their binaries. Built on the
    CPU, so it is the same whatever the device, and moved at the end."""
    return build_binaries(cfg, us, build_singles(cfg, us)).state.to(device)


def eccentric_orbit_ic(potential: pot_mod.Potential, r_apo: float,
                       r_peri: float):
    """In-plane phase-space point at apocentre of an (r_apo, r_peri) orbit,
    as host f64 lists. Energy and angular momentum matched in the midplane:
      L^2 = 2 (Φ(r_a) − Φ(r_p)) / (1/r_p² − 1/r_a²)
    """
    phi_a = float(potential.phi_R(r_apo))
    phi_p = float(potential.phi_R(r_peri))
    L2 = 2.0 * (phi_a - phi_p) / (1.0 / r_peri**2 - 1.0 / r_apo**2)
    v_t = math.sqrt(L2) / r_apo
    return [r_apo, 0.0, 0.0], [0.0, v_t, 0.0]


def _rot_x(vec, angle_rad: float):
    """Rotate a 3-vector about the x axis (tilts the orbital plane)."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    x, y, z = vec
    return [x, c * y - s * z, s * y + c * z]


def place_on_orbit(state: ParticleState,
                   potential: Optional[pot_mod.Potential], cfg: SimConfig,
                   us: UnitSystem) -> ParticleState:
    """Put the cluster's centre of mass on its galactic orbit: at (R0, 0, 0)
    moving prograde at v_circ(R0) for a circular orbit, at apocentre for an
    eccentric one; the orbital plane tilted about x by
    ``orbit.inclination_deg``. The offsets are host f64 arithmetic."""
    orbit = cfg.orbit
    if orbit.kind == "none":
        return state
    if potential is None:
        raise ValueError("orbit placement requires an external potential")
    length_scale = 1.0 / us.length_pc
    if orbit.kind == "circular":
        R0 = orbit.R0_pc * length_scale
        pos0 = [R0, 0.0, 0.0]
        vel0 = [0.0, float(potential.vcirc(R0)), 0.0]
    elif orbit.kind == "eccentric":
        pos0, vel0 = eccentric_orbit_ic(potential,
                                        orbit.r_apo_pc * length_scale,
                                        orbit.r_peri_pc * length_scale)
    else:
        raise ValueError(f"unknown orbit kind {orbit.kind!r}")
    if orbit.inclination_deg:
        ang = math.radians(orbit.inclination_deg)
        pos0, vel0 = _rot_x(pos0, ang), _rot_x(vel0, ang)
    return state.shifted(dpos=pos0, dvel=vel0)


def build_scene(cfg: SimConfig, device="cuda",
                mesh: Optional[Mesh] = None) -> Scene:
    """The scene on ``device``; on a mesh of more than one shard (``mesh``,
    or ``mesh.n_devices`` resolved) its force is a ShardedForce in the
    configured mode, whose results land on ``device``."""
    device = resolve_device(device)
    check_supported(cfg, device, mesh)
    mesh = resolve_mesh(cfg, device, mesh)
    us = build_units(cfg)
    external = build_external_potential(cfg, us)
    state = place_on_orbit(build_ic(cfg, us, device), external, cfg, us)
    if mesh is not None:
        force = make_sharded_force(cfg.integrator.eps, us.G, external,
                                   mesh=mesh, mode=mesh_mode(cfg),
                                   precision=cfg.integrator.precision)
    else:
        force = make_force_model(cfg.integrator.eps, us.G, external,
                                 precision=cfg.integrator.precision)
    return Scene(units=us, state=state, force=force, config=cfg)


def make_stepper(cfg: SimConfig, force: ForceModel):
    """The configured stepper and its kind: fixed-dt KDK, shared-dt
    Hermite-4 or block timesteps."""
    ic = cfg.integrator
    if ic.kind == "kdk":
        return LeapfrogKDK(force=force, dt=float(ic.dt)), "kdk"
    if ic.kind == "hermite":
        return Hermite4(force=force, eta=ic.eta, eta_init=ic.eta_init,
                        dt_max=ic.dt_max, quantize=ic.quantize,
                        pec2=ic.pec2, symmetrized=ic.symmetrized), "hermite"
    if ic.kind == "block":
        return BlockHermite(force=force, eta=ic.eta, eta_init=ic.eta_init,
                            dt_max=ic.dt_max, n_levels=ic.n_levels,
                            pec2=ic.pec2), "block"
    raise ValueError(f"unknown integrator kind {ic.kind!r}")
