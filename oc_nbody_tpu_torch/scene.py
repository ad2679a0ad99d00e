"""Scene building: units, the external field, the IC and its orbit.

Counterpart of ``oc_nbody_tpu/scene.py`` for the slice the port runs: a
Plummer cluster with equal masses, isolated or on a circular orbit in the
analytic Milky Way, integrated with fixed-dt KDK on one device. Every other
config value is refused with the ROADMAP item that ports it, so a config
never runs as something it does not say.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oc_nbody_tpu_torch.config import SimConfig
from oc_nbody_tpu_torch.forces import ForceModel, make_force_model
from oc_nbody_tpu_torch.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu_torch.models import potentials as pot_mod
from oc_nbody_tpu_torch.models.plummer import plummer
from oc_nbody_tpu_torch.state import ParticleState
from oc_nbody_tpu_torch.utils.units import UnitSystem

# (config path, the only value the port runs, ROADMAP item that ports the
# others)
_UNPORTED = (
    ("mesh.n_devices", 1, "A17 (multi-GPU)"),
    ("integrator.kind", "kdk", "A11/A12 (hermite, block), A14 (yoshida4)"),
    ("integrator.macro_batches", 0, "A18 (macro steppers)"),
    ("integrator.precision", "f32", "A13 (precision tiers)"),
    ("potential.perturber.kind", "none", "A14 (time-dependent fields)"),
    ("potential.bar.kind", "none", "A14 (time-dependent fields)"),
    ("potential.gas.kind", "none", "A14 (time-dependent fields)"),
    ("friction.kind", "none", "A14 (dynamical friction)"),
    ("sev.kind", "none", "A14 (stellar evolution)"),
    ("escape.prune", False, "A15 (escape pruning)"),
    ("ic.imf", "equal", "A4 (models/imf.py)"),
    ("ic.vel_scale", 1.0, "A8 (scene options)"),
    ("ic.rotation", 0.0, "A14 (models/rotation.py)"),
    ("ic.segregation", 0.0, "A14 (models/segregation.py)"),
    ("ic.binary_fraction", 0.0, "A14 (models/binaries.py)"),
    ("orbit.inclination_deg", 0.0, "A8 (scene options)"),
    ("output.diag_f64", False, "A13 (f64 diagnostics potential)"),
)
_IC_ITEMS = {"king": "A10", "dehnen": "A14", "eff": "A14",
             "file": "A3 (snapshot I/O)"}
_POTENTIAL_ITEMS = {"point_mass": "A4", "log_halo": "A4"}


@dataclasses.dataclass
class Scene:
    units: UnitSystem
    state: ParticleState
    force: ForceModel
    config: SimConfig


def _get(cfg, path: str):
    obj = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def check_supported(cfg: SimConfig) -> None:
    """Raise for a config the port cannot run as written."""
    if cfg.backend != "auto":
        raise ValueError(
            f"backend = {cfg.backend!r} names a JAX backend; the port takes "
            "'auto' only (the kernel or its plain twin is chosen by the "
            "tensors' device)")
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


def build_ic(cfg: SimConfig, us: UnitSystem, device) -> ParticleState:
    """The equal-mass Plummer IC, sampled from a generator seeded with
    ``ic.seed``."""
    ic = cfg.ic
    if ic.kind in _IC_ITEMS:
        raise NotImplementedError(f"ic.kind {ic.kind!r} is not ported yet "
                                  f"(ROADMAP {_IC_ITEMS[ic.kind]})")
    if ic.kind != "plummer":
        raise ValueError(f"unknown IC kind {ic.kind!r}")
    gen = torch.Generator().manual_seed(ic.seed)
    return plummer(ic.n, gen, a=ic.a, total_mass=ic.total_mass, G=us.G,
                   device=device)


def place_on_orbit(state: ParticleState,
                   potential: Optional[pot_mod.Potential], cfg: SimConfig,
                   us: UnitSystem) -> ParticleState:
    """Put the cluster's centre of mass on its galactic orbit: at (R0, 0, 0)
    moving prograde at v_circ(R0) for a circular orbit."""
    orbit = cfg.orbit
    if orbit.kind == "none":
        return state
    if potential is None:
        raise ValueError("orbit placement requires an external potential")
    if orbit.kind == "eccentric":
        raise NotImplementedError("orbit.kind 'eccentric' is not ported yet "
                                  "(ROADMAP A8)")
    if orbit.kind != "circular":
        raise ValueError(f"unknown orbit kind {orbit.kind!r}")
    R0 = orbit.R0_pc / us.length_pc
    return state.shifted(dpos=[R0, 0.0, 0.0],
                         dvel=[0.0, float(potential.vcirc(R0)), 0.0])


def build_scene(cfg: SimConfig, device="cuda") -> Scene:
    check_supported(cfg)
    device = resolve_device(device)
    us = build_units(cfg)
    external = build_external_potential(cfg, us)
    state = place_on_orbit(build_ic(cfg, us, device), external, cfg, us)
    force = make_force_model(cfg.integrator.eps, us.G, external)
    return Scene(units=us, state=state, force=force, config=cfg)


def make_stepper(cfg: SimConfig, force: ForceModel):
    """The configured stepper and its kind: fixed-dt KDK."""
    return LeapfrogKDK(force=force, dt=float(cfg.integrator.dt)), "kdk"
