"""Primordial binary populations for cluster initial conditions
(counterpart of ``oc_nbody_tpu/models/binaries.py``).

A chosen fraction of an existing IC's stars is split into two-body pairs
whose internal orbits follow the standard population-synthesis
distributions:

  * semi-major axis a: log-uniform on [a_min, a_max] (Öpik's law),
  * eccentricity e: thermal, f(e) = 2e  =>  e = e_max sqrt(u),
  * mass ratio q = m2/m1: uniform on [q_min, 1]; the components share the
    parent star's mass, so the cluster's total mass and the IMF's
    system-mass function are preserved,
  * orientation: Haar-uniform random rotation (unit quaternion),
  * orbital phase: mean anomaly uniform on [0, 2 pi), mapped to the
    eccentric anomaly by a fixed-count Newton solve of Kepler's equation.

Each pair is placed at its parent star's phase-space point (the pair's
centre of mass is the removed single, in position and velocity), so the
parent IC's cluster-scale structure is untouched; only the internal binary
energy -G m1 m2 / 2a per pair is added.

The force kernels are softened: a binary with a <~ eps is not resolved as a
binary. Choose a_min a few times eps (the scene refuses a_min < 2 eps), or
run the extended or df32 precision tier with a small eps.

The draws come from a ``torch.Generator`` (``draw_binaries``); the state is
a plain function of the draws (``add_binaries(..., draws=...)``), so the
JAX package's draws give the JAX package's state. Everything runs in f64 on
the state's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from oc_nbody_tpu_torch.state import ParticleState

_F64 = torch.float64


def solve_kepler(mean_anom, ecc, n_iter: int = 12):
    """Eccentric anomaly E with E - e sin E = M, elementwise, f64: a
    fixed-count Newton iteration from the starter E0 = M + e sin M
    (adequate for e <= ~0.95; the thermal sampling is cut at e_max)."""
    m = torch.as_tensor(mean_anom, dtype=_F64)
    e = torch.as_tensor(ecc, dtype=_F64, device=m.device)
    ea = m + e * torch.sin(m)
    for _ in range(n_iter):
        f = ea - e * torch.sin(ea) - m
        ea = ea - f / (1.0 - e * torch.cos(ea))
    return ea


def _random_rotations(u):
    """(n, 3, 3) Haar-uniform rotation matrices from the (3, n) unit
    uniforms ``u``, via unit quaternions."""
    u1, u2, u3 = u
    s1, s2 = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    w = s1 * torch.sin(2 * math.pi * u2)
    x = s1 * torch.cos(2 * math.pi * u2)
    y = s2 * torch.sin(2 * math.pi * u3)
    z = s2 * torch.cos(2 * math.pi * u3)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def kepler_orbit_phase(a, e, mean_anom, gm_tot):
    """(r_rel, v_rel), each (..., 3): separation and relative velocity of
    body 1 with respect to body 2 on a Kepler ellipse of total
    gravitational parameter ``gm_tot`` = G (m1 + m2), at the phase given by
    the mean anomaly, in the perifocal frame (x toward pericentre, z along
    the orbital angular momentum)."""
    a = torch.as_tensor(a, dtype=_F64)
    e = torch.as_tensor(e, dtype=_F64, device=a.device)
    ea = solve_kepler(mean_anom, e)
    cose, sine = torch.cos(ea), torch.sin(ea)
    b_over_a = torch.sqrt(torch.clamp(1.0 - e * e, min=0.0))
    x = a * (cose - e)
    y = a * b_over_a * sine
    # dE/dt = n / (1 - e cos E), n = sqrt(gm / a^3)
    edot = torch.sqrt(gm_tot / a ** 3) / (1.0 - e * cose)
    vx = -a * sine * edot
    vy = a * b_over_a * cose * edot
    zeros = torch.zeros_like(x)
    return (torch.stack([x, y, zeros], dim=-1),
            torch.stack([vx, vy, zeros], dim=-1))


def orbital_elements(r_rel, v_rel, gm_tot):
    """(a, e) from relative separation and velocity; inverts
    ``kepler_orbit_phase``. a from the vis-viva energy v²/2 - gm/r =
    -gm/(2a), e from |h| with e² = 1 + 2 E h² / gm². An unbound pair
    returns a < 0."""
    r_rel = torch.as_tensor(r_rel, dtype=_F64)
    v_rel = torch.as_tensor(v_rel, dtype=_F64)
    r = torch.linalg.vector_norm(r_rel, dim=-1)
    v2 = torch.sum(v_rel * v_rel, dim=-1)
    eps_orb = 0.5 * v2 - gm_tot / r
    a = -gm_tot / (2.0 * eps_orb)
    h = torch.linalg.cross(r_rel, v_rel, dim=-1)
    h2 = torch.sum(h * h, dim=-1)
    e2 = 1.0 + 2.0 * eps_orb * h2 / gm_tot ** 2
    return a, torch.sqrt(torch.clamp(e2, min=0.0))


@dataclasses.dataclass(frozen=True)
class BinaryDraws:
    """The random numbers one binary population is a function of, for n_b
    binaries among n systems (the JAX package's six streams)."""

    sel: torch.Tensor        # (n_b,) parent indices, distinct
    log_a: torch.Tensor      # (n_b,) uniform on [log a_min, log a_max)
    u_e: torch.Tensor        # (n_b,) unit uniform; e = e_max sqrt(u_e)
    q: torch.Tensor          # (n_b,) uniform on [q_min, 1)
    mean_anom: torch.Tensor  # (n_b,) uniform on [0, 2 pi)
    u_rot: torch.Tensor      # (3, n_b) unit uniforms of the orientations


def draw_binaries(n: int, n_b: int, gen: torch.Generator, a_min: float,
                  a_max: float, q_min: float) -> BinaryDraws:
    """The draws of ``n_b`` binaries among ``n`` systems from a CPU
    generator, in f64 (parents uniformly without replacement)."""
    def uniform(lo, hi, shape=(n_b,)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=_F64)

    return BinaryDraws(
        sel=torch.randperm(n, generator=gen)[:n_b],
        log_a=uniform(math.log(a_min), math.log(a_max)),
        u_e=uniform(0.0, 1.0), q=uniform(q_min, 1.0),
        mean_anom=uniform(0.0, 2.0 * math.pi),
        u_rot=uniform(0.0, 1.0, (3, n_b)))


@dataclasses.dataclass(frozen=True)
class BinaryPopulation:
    """The new state and the pair bookkeeping. ``primary_idx`` and
    ``secondary_idx`` index into ``state``: component 1 keeps the parent
    star's slot and id, component 2 is appended with a fresh id. ``a`` and
    ``e`` are the sampled elements in code units."""

    state: ParticleState
    primary_idx: torch.Tensor    # (n_b,) int32
    secondary_idx: torch.Tensor  # (n_b,) int32
    a: torch.Tensor              # (n_b,) f64
    e: torch.Tensor              # (n_b,) f64


def add_binaries(state: ParticleState, gen: Optional[torch.Generator],
                 fraction: float, a_min: float, a_max: float, *,
                 G: float = 1.0, q_min: float = 0.1, e_max: float = 0.95,
                 draws: Optional[BinaryDraws] = None) -> BinaryPopulation:
    """Split ``round(fraction * N)`` stars of ``state`` into binary pairs.

    ``fraction`` is the binary fraction by SYSTEM count: n_b binaries among
    N systems, so the returned state has N + n_b particles. Each parent of
    mass m becomes components m/(1+q) and m q/(1+q) at its phase-space
    point, on an internal orbit drawn from ``gen`` (``draw_binaries``) or
    given as ``draws``."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"binary fraction must be in [0, 1], got {fraction}")
    if not 0.0 < a_min <= a_max:
        raise ValueError(f"need 0 < a_min <= a_max, got ({a_min}, {a_max})")
    if not 0.0 < q_min <= 1.0:
        raise ValueError(f"q_min must be in (0, 1], got {q_min}")
    n = state.n
    dev = state.device
    n_b = int(round(fraction * n))
    if n_b == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        none = torch.zeros((0,), dtype=_F64, device=dev)
        return BinaryPopulation(state=state, primary_idx=empty,
                                secondary_idx=empty, a=none, e=none)
    if draws is None:
        draws = draw_binaries(n, n_b, gen, a_min, a_max, q_min)
    sel = draws.sel.to(device=dev, dtype=torch.int64)
    log_a, u_e, q, mean_anom, u_rot = (
        t.to(device=dev, dtype=_F64) for t in
        (draws.log_a, draws.u_e, draws.q, draws.mean_anom, draws.u_rot))
    a = torch.exp(log_a)
    e = e_max * torch.sqrt(u_e)

    # The component masses are rounded to the state's mass dtype (f32)
    # FIRST and the orbit weights use the rounded values: the pair's centre
    # of mass recomputed from the stored state is then exact to f64
    # rounding, not to f32 mass rounding.
    mdt = state.mass.dtype
    m_parent = state.mass[sel].to(_F64)
    m1 = (m_parent / (1.0 + q)).to(mdt)
    m2 = (m_parent - m1.to(_F64)).to(mdt)
    m1, m2 = m1.to(_F64), m2.to(_F64)
    m_pair = m1 + m2

    r_rel, v_rel = kepler_orbit_phase(a, e, mean_anom, G * m_pair)
    rot = _random_rotations(u_rot)
    r_rel = torch.einsum("nij,nj->ni", rot, r_rel)
    v_rel = torch.einsum("nij,nj->ni", rot, v_rel)

    com_pos, com_vel = state.pos[sel], state.vel[sel]
    w1 = (m2 / m_pair)[:, None]     # component 1's offset weight
    w2 = (m1 / m_pair)[:, None]

    def both(base, first, second):
        out = base.clone()
        out[sel] = first.to(base.dtype)
        return torch.cat([out, second.to(base.dtype)])

    new_ids = (torch.max(state.ids) + 1
               + torch.arange(n_b, dtype=state.ids.dtype, device=dev))
    new_state = ParticleState(
        pos=both(state.pos, com_pos + w1 * r_rel, com_pos - w2 * r_rel),
        vel=both(state.vel, com_vel + w1 * v_rel, com_vel - w2 * v_rel),
        mass=both(state.mass, m1, m2),
        ids=torch.cat([state.ids, new_ids]), time=state.time)
    return BinaryPopulation(
        state=new_state, primary_idx=sel.to(torch.int32),
        secondary_idx=(n + torch.arange(n_b, device=dev)).to(torch.int32),
        a=a, e=e)
