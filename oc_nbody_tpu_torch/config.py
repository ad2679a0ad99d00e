"""Typed configuration tree: JSON/TOML loadable, CLI dot-overrides.

Capability parity: SURVEY.md §2.13 / §5 "config/flag system" — a typed
``SimConfig`` dataclass tree (ic / units / potential / orbit / integrator /
output / mesh sections). The five acceptance configs (BASELINE.json:6-12)
ship as committed TOML files under configs/.

Times/lengths are in *code units* (Hénon units when units.kind == "henon");
fields suffixed ``_pc`` / ``_myr`` / ``_msun`` are physical and are
converted by scene.py.

A copy of ``oc_nbody_tpu/config.py`` (which imports no JAX, but importing it
through ``oc_nbody_tpu`` would): both packages parse every config file to
the same tree. The port's scene refuses the sections it has not ported.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["SimConfig", "load_config", "apply_overrides"]


@dataclasses.dataclass
class UnitsConfig:
    kind: str = "henon"          # henon | physical (pc/Myr/Msun)
    mass_msun: float = 1000.0    # physical cluster mass (henon scaling)
    length_pc: float = 1.0       # physical virial radius (henon scaling)


@dataclasses.dataclass
class ICConfig:
    kind: str = "plummer"        # plummer | king | dehnen | eff | file
    n: int = 1024
    a: Optional[float] = None    # plummer/eff scale radius (code units)
    w0: float = 6.0              # king concentration parameter
    gamma: float = 1.0           # dehnen inner slope [0,3) / eff envelope
    # slope (>2); sampled via Eddington inversion (models/eddington.py)
    r_cut: Optional[float] = None  # dehnen/eff truncation radius
    # (pre-Hénon-rescale profile units; default: dehnen 99.8% mass, eff 30a)
    r_aniso: Optional[float] = None  # dehnen/eff Osipkov-Merritt anisotropy
    # radius (profile units): beta(r) = r²/(r²+r_a²); None = isotropic
    total_mass: float = 1.0      # code units
    imf: str = "equal"           # equal | kroupa | salpeter
    m_min_msun: float = 0.08
    m_max_msun: float = 100.0
    seed: int = 0
    file: Optional[str] = None   # snapshot path when kind == "file"
    # net rotation (models/rotation.py, Lynden-Bell sign-flip): fraction
    # of retrograde stars made prograde about z. Preserves every star's
    # energy and L², so the model stays in equilibrium; 1.0 = maximal
    # rotation for the chosen profile.
    rotation: float = 0.0
    # primordial mass segregation (models/segregation.py): rank-correlate
    # IMF masses with binding energy, 0 = none, 1 = perfect ordering.
    # Requires a mass spectrum.
    segregation: float = 0.0
    # uniform velocity multiplier applied after IC generation (before
    # rotation/binaries). ≈ sqrt(1 + M_gas/M_cluster) re-virializes a
    # cluster embedded in a [potential.gas] background; < 1 makes a
    # cold collapsing IC.
    vel_scale: float = 1.0
    # primordial binaries (models/binaries.py): split binary_fraction of
    # the IC's stars into pairs (the state then has n*(1+fraction) rows).
    # a_min/a_max are the log-uniform semi-major-axis bounds in CODE
    # units — pick a_min at least a few times integrator.eps or the pair
    # is softened away (models/binaries.py docstring).
    binary_fraction: float = 0.0
    binary_a_min: Optional[float] = None
    binary_a_max: Optional[float] = None
    binary_q_min: float = 0.1
    binary_e_max: float = 0.95


@dataclasses.dataclass
class PerturberConfig:
    """A moving perturber ADDED to the main potential (GMC / dwarf-galaxy
    flyby): models/potentials.py MovingCenter on a linear or circular
    galactocentric trajectory. All parameters physical (pc, km/s, Myr)."""

    kind: str = "none"           # none | plummer | point_mass
    mass_msun: float = 1.0e5
    scale_pc: float = 10.0       # Plummer b / point-mass softening
    trajectory: str = "linear"   # linear | circular
    # linear: start position + constant velocity
    x0_pc: tuple = (-8000.0, 100.0, 0.0)
    v0_kms: tuple = (20.0, 0.0, 0.0)
    # circular: radius/phase/plane; period_myr = 0 derives the angular
    # rate from the MAIN potential's v_circ at that radius
    radius_pc: float = 8000.0
    period_myr: float = 0.0
    phase_deg: float = 0.0
    z0_pc: float = 0.0


@dataclasses.dataclass
class BarConfig:
    """A rotating Long–Murali bar ADDED to the main potential
    (models/potentials.py LongMuraliBar inside Rotating, optionally
    Ramped for adiabatic growth)."""

    kind: str = "none"           # none | long_murali
    mass_msun: float = 1.0e10
    a_pc: float = 4000.0         # half-length
    b_pc: float = 1000.0         # in-plane softening
    c_pc: float = 500.0          # vertical softening
    pattern_speed_kms_kpc: float = 39.0
    angle0_deg: float = 28.0     # bar angle at t = 0
    grow_myr: float = 0.0        # > 0: Dehnen ramp over [0, grow_myr]


@dataclasses.dataclass
class GasConfig:
    """[potential.gas] — embedded natal-gas background (scene._build_gas):
    a Plummer sphere comoving with the cluster (static, or riding the
    circular [orbit]), expelled with the C² Dehnen ramp run in reverse
    over [t_expel_myr, t_expel_myr + expel_myr]. The classic early-
    cluster survival ("infant mortality") mechanism. The gas is a rigid
    background — not depleted self-consistently. Start the embedded
    phase in equilibrium with the combined well via ic.vel_scale ≈
    sqrt(1 + M_gas/M_cluster)."""

    kind: str = "none"          # none | plummer
    mass_msun: float = 0.0      # gas mass (physical)
    scale_pc: float = 1.0       # Plummer scale radius
    t_expel_myr: float = 0.0    # expulsion start (code t = from run start)
    expel_myr: float = 0.0      # expulsion duration; 0 = never expelled


@dataclasses.dataclass
class PotentialConfig:
    kind: str = "none"           # none | milky_way | point_mass | log_halo
    # point_mass params (physical)
    mass_msun: float = 1.0e11
    softening_pc: float = 0.0
    # log_halo params: flat-rotation-curve spherical halo
    v0_kms: float = 220.0
    rc_pc: float = 1000.0
    # time-dependent additions ([potential.perturber] / [potential.bar])
    perturber: PerturberConfig = dataclasses.field(
        default_factory=PerturberConfig)
    bar: BarConfig = dataclasses.field(default_factory=BarConfig)
    gas: GasConfig = dataclasses.field(default_factory=GasConfig)


@dataclasses.dataclass
class SEVConfig:
    """[sev] — stellar evolution (models/stellar_evolution.py): analytic
    main-sequence lifetimes → instantaneous remnant formation (WD/NS/BH
    initial–final mass relation) with optional Maxwellian natal kicks.
    Applied by the run loop at every diagnostics boundary; the energy
    carried away is accounted in the E_sev_cum diagnostics column.
    Physical masses are m_code * units.mass_msun — set units.mass_msun
    to the cluster's physical mass (n · ⟨m⟩_IMF) for realistic clocks."""

    kind: str = "none"            # none | simple
    epoch0_myr: float = 0.0       # cluster age at t = 0 (stars with
    # t_MS < epoch0 are remnants from the start)
    kick_sigma_ns_kms: float = 0.0  # per-component Maxwellian σ, NS natal kick
    kick_sigma_bh_kms: float = 0.0  # … BH
    kick_sigma_wd_kms: float = 0.0  # … WD (usually 0)
    m_ns_min_msun: float = 8.0    # IFMR: WD below, NS from here
    m_bh_min_msun: float = 20.0   # IFMR: BH from here
    m_ns_msun: float = 1.4        # fixed NS mass
    # winds: this fraction of each star's total mass loss leaves as a
    # linear wind over the last wind_time_frac of its lifetime; the rest
    # drops instantaneously at collapse (where any kick is applied).
    # 0 = all loss at death (default); kicks require <= 0.9.
    wind_fraction: float = 0.0
    wind_time_frac: float = 0.1


@dataclasses.dataclass
class OrbitConfig:
    kind: str = "none"           # none | circular | eccentric
    R0_pc: float = 8000.0        # circular orbit radius
    r_apo_pc: float = 8000.0     # eccentric orbit apocentre
    r_peri_pc: float = 4000.0    # eccentric orbit pericentre
    inclination_deg: float = 0.0  # tilt of the orbital plane (disk crossing)


@dataclasses.dataclass
class IntegratorConfig:
    kind: str = "kdk"            # kdk | yoshida4 | hermite | block
    dt: float = 1.0 / 1024.0     # kdk/yoshida4 fixed step (code units)
    eps: float = 1.0 / 256.0     # softening length (code units)
    eta: float = 0.02            # hermite/block accuracy parameter
    eta_init: float = 0.01
    dt_max: float = 1.0 / 16.0   # hermite/block upper clamp
    quantize: bool = False       # hermite: snap shared dt to dt_max/2^k
    pec2: bool = False           # hermite/block: second corrector pass (PEC²)
    symmetrized: bool = False    # hermite: time-symmetrized dt selection
    # (Hut–Makino–McMillan) — kills the secular drift of adaptive dt on
    # periodic (binary-dominated) orbits at +1 force eval/step
    n_levels: int = 8            # block: number of power-of-two rungs
    # block: pair-aware rung criterion — additionally cap each active
    # row's dt at eta_pair × its minimum softened two-body encounter
    # timescale (fly-by AND free-fall). The force-only Aarseth dt GROWS
    # through the softened core (a → 0 at r → 0), under-stepping
    # eccentric hard pairs exactly at pericentre (measured ~3e-3
    # |dE/E_int| random walk on configs/binaries_8k.toml without it).
    pair_dt: bool = False
    eta_pair: float = 0.0        # 0 → use eta
    pair_r_max: float = 4.0      # near-field window, eps units (0 = none)
    precision: str = "f32"       # pairwise tier: f32 | extended | df32
    # kdk + hermite: > 0 switches to the host-stepped Macro stepper
    # (MacroKDK / MacroHermite) with this many dispatches per force
    # eval — for N past the single-XLA-program window (~4M+; one
    # monolithic eval there is a 60-240 s program, past runtime
    # watchdogs). 0 = normal in-jit superstep. Block timesteps have no
    # macro form (the active-row eval is already small).
    macro_batches: int = 0


@dataclasses.dataclass
class FrictionConfig:
    """Chandrasekhar dynamical friction on the cluster orbit
    (models/friction.py): a rigid CoM drag from the host potential's own
    density (autodiff Laplacian), applied uniformly to every star. Needs
    an external potential; supported for kdk/yoshida4/hermite in-jit
    steppers on a single device. E_tot decays physically while this is
    on — dE/E stops being a conservation check (the run loop emits the
    instantaneous |a_df| column)."""

    kind: str = "none"           # none | chandrasekhar
    ln_lambda: float = 0.0       # Coulomb logarithm, REQUIRED > 0 when on
    sigma_kms: float = 0.0       # field dispersion; 0 → vcirc(r)/sqrt(2)


@dataclasses.dataclass
class EscapeConfig:
    """Escape pruning (oc_nbody_tpu/escape.py): stars beyond
    ``r_cut`` tidal radii of the density centre stop being pairwise force
    SOURCES (they stay fully integrated targets). Pairwise cost drops from
    O(N²) to O(N·bucket); the dropped tail–tail energy is ledgered in the
    ``E_prune_cum`` diagnostics column. Re-partitioned at every
    diagnostics boundary. Requires an external potential (the cut is in
    tidal radii), the f32 tier, a single-device run, and no
    macro_batches."""

    prune: bool = False
    r_cut: float = 2.0           # cut radius in units of r_tidal
    min_bucket: int = 4096       # smallest source bucket (pow-2 sizing —
    # bounds recompiles to O(log N) programs per run)


@dataclasses.dataclass
class OutputConfig:
    out_dir: str = "out/run"
    t_end: float = 10.0          # code units
    diag_every: float = 0.25     # diagnostics cadence (code units)
    snap_every: float = 1.0      # snapshot cadence (code units)
    # physical-time alternatives: when set (Myr), they override the
    # code-unit fields above via the scene's unit system
    t_end_myr: Optional[float] = None
    diag_every_myr: Optional[float] = None
    snap_every_myr: Optional[float] = None
    fractions: tuple = (0.1, 0.25, 0.5, 0.75, 0.9)
    stdout: bool = True
    max_steps_per_dispatch: int = 16384  # cap steps per device dispatch
    diag_f64: bool = False       # full-f64 pairwise PE in diagnostics (slow)
    core_diag: bool = True       # CH85 r_core/rho_core columns (one extra
    # bounded O(min(N,65k)²) distance sweep per diagnostics row)
    # ensemble mode: warn when any member's |dE/E_int| exceeds this bound
    # (0 = off). A survey containing one mis-stepped member would
    # otherwise report integrator error as physics (VERDICT round-3 W3).
    # Default 3e-4 (round-5, VERDICT W5): ~2x the worst member measured
    # in the 48-run kick-survey grid (1.5e-4) — a gate that enforces the
    # observed health envelope instead of documenting it. Set 0 to
    # disable, or higher for deliberately coarse exploratory surveys.
    drift_warn: float = 3e-4


@dataclasses.dataclass
class MeshConfig:
    n_devices: int = 1           # 0 = all visible devices
    mode: str = "auto"           # auto | allgather | ring | rdma (Pallas
    # RDMA ring) | halfring (pair-symmetric: each shard pair once)


@dataclasses.dataclass
class SimConfig:
    units: UnitsConfig = dataclasses.field(default_factory=UnitsConfig)
    ic: ICConfig = dataclasses.field(default_factory=ICConfig)
    potential: PotentialConfig = dataclasses.field(default_factory=PotentialConfig)
    orbit: OrbitConfig = dataclasses.field(default_factory=OrbitConfig)
    sev: SEVConfig = dataclasses.field(default_factory=SEVConfig)
    friction: FrictionConfig = dataclasses.field(default_factory=FrictionConfig)
    escape: EscapeConfig = dataclasses.field(default_factory=EscapeConfig)
    integrator: IntegratorConfig = dataclasses.field(default_factory=IntegratorConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    backend: str = "auto"        # force kernel backend: auto | jnp | pallas

    # ---- (de)serialisation -------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        d = self.to_dict()
        d["output"]["fractions"] = list(d["output"]["fractions"])
        return json.dumps(d, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        cfg = cls()
        for section, value in d.items():
            if not hasattr(cfg, section):
                raise KeyError(f"unknown config section {section!r}")
            current = getattr(cfg, section)
            if dataclasses.is_dataclass(current):
                _apply_section(current, value, section)
            else:
                setattr(cfg, section, value)
        return cfg


def _apply_section(obj, d: dict, path: str) -> None:
    """Recursively apply a (possibly nested) config dict onto a dataclass
    tree — nested TOML tables like [potential.perturber] land on nested
    dataclass fields; unknown keys stay loud errors with their full path."""
    names = {f.name: f for f in dataclasses.fields(obj)}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown key {path}.{k}")
        current = getattr(obj, k)
        if dataclasses.is_dataclass(current):
            if not isinstance(v, dict):
                # a scalar here would silently replace the whole nested
                # section and surface later as a distant AttributeError
                raise TypeError(
                    f"{path}.{k} is a config section (table); got "
                    f"{type(v).__name__} {v!r}")
            _apply_section(current, v, f"{path}.{k}")
        else:
            setattr(obj, k, _coerce(v, names[k].type))


def _coerce(value, type_str):
    if isinstance(type_str, str):
        if type_str.startswith("Optional"):
            if value is None:
                return None
            type_str = type_str[len("Optional["):-1]
        if type_str == "float":
            return float(value)
        if type_str == "int":
            return int(value)
        if type_str == "bool":
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes", "on")
            return bool(value)
        if type_str == "tuple":
            return tuple(value) if not isinstance(value, tuple) else value
    return value


def _load_raw(path: str) -> dict:
    if path.endswith((".toml", ".tml")):
        import tomllib
        with open(path, "rb") as f:
            return tomllib.load(f)
    with open(path) as f:
        return json.load(f)


def _deep_merge(base: dict, over: dict) -> dict:
    """Layer ``over`` onto ``base`` (section dicts merge key-wise)."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_includes(path: str, _seen: frozenset = frozenset()) -> dict:
    """Config presets: a top-level ``include = "base.toml"`` (string or
    list) pulls in other config files, resolved relative to the including
    file; the including file's own values win. Includes nest; cycles are
    an error."""
    import os
    path = os.path.abspath(path)
    if path in _seen:
        raise ValueError(f"config include cycle via {path!r}")
    d = _load_raw(path)
    includes = d.pop("include", None)
    if not includes:
        return d
    if isinstance(includes, str):
        includes = [includes]
    base: dict = {}
    for inc in includes:
        inc_path = os.path.join(os.path.dirname(path), inc)
        base = _deep_merge(base,
                           _resolve_includes(inc_path, _seen | {path}))
    return _deep_merge(base, d)


def load_config(path: str) -> SimConfig:
    return SimConfig.from_dict(_resolve_includes(path))


def apply_overrides(cfg: SimConfig, overrides: list[str]) -> SimConfig:
    """Apply ``section.key=value`` CLI overrides in place."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form a.b=v")
        dotted, raw = item.split("=", 1)
        parts = dotted.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        field = {f.name: f for f in dataclasses.fields(obj)}.get(leaf)
        if field is None:
            raise KeyError(f"unknown config key {dotted!r}")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        if dataclasses.is_dataclass(getattr(obj, leaf)):
            raise TypeError(
                f"{dotted!r} is a config section; override its fields "
                f"(e.g. --set {dotted}.kind=...) instead")
        setattr(obj, leaf, _coerce(value, field.type))
    return cfg
