"""Diagnostics on the device: energies, angular momentum, Lagrangian radii,
density centre, bound mass (energy cut and iterative tidal-radius cut),
velocity dispersion, relaxation time and the CH85 core.

Counterpart of ``oc_nbody_tpu/diagnostics.py``: the same formulas, loops
and column names, accumulated in f64. Every function returns device
tensors and never waits for the device; run.py copies a finished row
to the host once.
"""
from __future__ import annotations

import math

import torch

from oc_nbody_tpu_torch.forces import ForceModel
from oc_nbody_tpu_torch.ops.gravity import rounded
from oc_nbody_tpu_torch.state import ParticleState

_F64 = torch.float64


def _f64(t):
    return t.to(_F64)


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    m = _f64(state.mass)
    return 0.5 * torch.sum(m * torch.sum(_f64(state.vel) ** 2, dim=1))


def energies(state: ParticleState, force: ForceModel,
             precomputed_phi=None) -> dict:
    """KE, pairwise PE, external potential energy, total. All f64 scalars.

    ``E_int`` is the cluster-internal energy — KE in the mass-weighted COM
    velocity frame plus the pairwise PE. On orbit runs E_tot is dominated by
    the galactic well, so run.py normalises drift by |E_int(t=0)|."""
    force = force.at_time(state.time)
    m = _f64(state.mass)
    if precomputed_phi is None:
        _, phi_pair, phi_ext = force.accel_potential(state.pos, state.mass)
    else:
        phi_pair, phi_ext = precomputed_phi
    ke = kinetic_energy(state)
    pe_pair = 0.5 * torch.sum(m * _f64(phi_pair))
    e_ext = torch.sum(m * _f64(phi_ext))
    vel = _f64(state.vel)
    vbar = torch.sum(vel * m[:, None], dim=0) / torch.sum(m)
    ke_int = 0.5 * torch.sum(m * torch.sum((vel - vbar) ** 2, dim=1))
    return {
        "KE": ke,
        "PE_pair": pe_pair,
        "E_ext": e_ext,
        "E_tot": ke + pe_pair + e_ext,
        "E_int": ke_int + pe_pair,
    }


def angular_momentum(state: ParticleState, center=None,
                     center_vel=None) -> torch.Tensor:
    """Total L = sum m (r - c) x (v - vc), (3,) float64."""
    pos, vel = _f64(state.pos), _f64(state.vel)
    if center is not None:
        pos = pos - center
    if center_vel is not None:
        vel = vel - center_vel
    m = _f64(state.mass)
    return torch.sum(m[:, None] * torch.linalg.cross(pos, vel), dim=0)


def density_center(state: ParticleState, n_iter: int = 24,
                   shrink: float = 0.9, min_frac: float = 0.05):
    """Shrinking-sphere density centre (Casertano–Hut-style), branch-free:
    recentre on the mass inside a shrinking sphere; stop shrinking (keep
    the last good centre) once the enclosed mass fraction drops below
    ``min_frac``."""
    pos, m = _f64(state.pos), _f64(state.mass)
    m_tot = torch.sum(m)
    c = torch.sum(pos * m[:, None], dim=0) / m_tot
    r = torch.max(torch.linalg.norm(pos - c, dim=1))
    for _ in range(n_iter):
        d = torch.linalg.norm(pos - c, dim=1)
        w = m * (d < r)
        wsum = torch.sum(w)
        ok = wsum > min_frac * m_tot
        c = torch.where(ok, torch.sum(pos * w[:, None], dim=0)
                        / torch.clamp(wsum, min=1e-300), c)
        r = torch.where(ok, r * shrink, r)
    return c


def lagrangian_radii(state: ParticleState,
                     fractions=(0.1, 0.25, 0.5, 0.75, 0.9),
                     center=None, mask=None):
    """Radii enclosing the given mass fractions about ``center`` (default:
    density centre); ``mask`` restricts to a subset (e.g. bound stars).
    NaN when the selection holds no mass."""
    if center is None:
        center = density_center(state)
    pos, m = _f64(state.pos), _f64(state.mass)
    if mask is not None:
        m = m * mask
    r = torch.linalg.norm(pos - center, dim=1)
    order = torch.argsort(r, stable=True)
    csum = torch.cumsum(m[order], dim=0)
    targets = torch.tensor(fractions, dtype=_F64, device=r.device) * csum[-1]
    idx = torch.clamp(torch.searchsorted(csum, targets), 0, r.shape[0] - 1)
    return torch.where(csum[-1] > 0, r[order][idx], math.nan)


def local_density(pos, mass, center, k: int = 6, max_probes: int = 65536,
                  max_sources: int = 65536, chunk: int = 256,
                  r_min: float = 0.0):
    """Casertano & Hut (1985) kth-nearest-neighbour local density:
    rho_j = (mass of the k-1 nearest) / (4pi/3 r_k^3), self excluded, with
    r_k floored at ``r_min``. Probes and sources are strided down to
    ``max_probes`` / ``max_sources`` (sampled source masses scaled by the
    stride). Distances are f32 on coordinates centred on ``center``.

    The kth distance comes from k threshold passes, with the JAX package's
    tie semantics: exact-duplicate f32 distances collapse to one rank and
    all tied masses count. Returns (rho, probe_stride); rho (f64) is
    aligned with pos[::probe_stride]."""
    if k < 2:
        raise ValueError("CH85 local density needs k >= 2")
    n = pos.shape[0]
    ps = -(-n // max_probes)
    ss = -(-n // max_sources)
    probes = (pos - center)[::ps].to(torch.float32)
    src = (pos - center)[::ss].to(torch.float32)
    msrc = mass[::ss].to(torch.float32) * float(ss)
    if src.shape[0] <= k:
        return torch.full((probes.shape[0],), math.nan, dtype=_F64,
                          device=pos.device), ps
    f32 = torch.float32
    rmin2 = rounded(max(rounded(r_min, f32) ** 2, 1e-30), f32)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=pos.device)
    rhos = []
    for i0 in range(0, probes.shape[0], chunk):
        p = probes[i0:i0 + chunk]
        d2 = torch.sum((p[:, None, :] - src[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(d2 <= 0.0, inf, d2)  # self pairs
        thr = torch.min(d2, dim=1).values     # rank-1 distance²
        thr_prev = thr
        for _ in range(k - 1):
            thr_prev = thr
            thr = torch.min(torch.where(d2 <= thr[:, None], inf, d2),
                            dim=1).values     # next rank
        mnb = torch.sum(torch.where(d2 <= thr_prev[:, None], msrc[None, :],
                                    0.0), dim=1)
        rk2 = _f64(torch.clamp(thr, min=rmin2))
        rhos.append(_f64(mnb) / ((4.0 * math.pi / 3.0) * rk2 ** 1.5))
    return torch.cat(rhos), ps


def core_radius_density(state: ParticleState, center=None, k: int = 6,
                        mask=None, max_probes: int = 65536,
                        max_sources: int = 65536, r_min: float = 0.0):
    """Core radius (rho²-weighted rms radius) and central density
    (rho-weighted mean density) from CH85 local densities. ``mask``
    restricts which stars are weighted. (NaN, NaN) for N <= k+1 or an
    empty selection."""
    n = state.pos.shape[0]
    if n <= k + 1:
        nan = torch.tensor(math.nan, dtype=_F64, device=state.device)
        return nan, nan
    if center is None:
        center = density_center(state)
    rho, ps = local_density(state.pos, state.mass, center, k=k,
                            max_probes=max_probes, max_sources=max_sources,
                            r_min=r_min)
    r2 = torch.sum((_f64(state.pos[::ps]) - center) ** 2, dim=1)
    if mask is not None:
        rho = rho * mask[::ps]
    w = rho * rho
    wsum = torch.clamp(torch.sum(w), min=1e-300)
    r_core = torch.sqrt(torch.sum(w * r2) / wsum)
    rho_core = wsum / torch.clamp(torch.sum(rho), min=1e-300)
    ok = torch.sum(rho) > 0
    return (torch.where(ok, r_core, math.nan),
            torch.where(ok, rho_core, math.nan))


def velocity_dispersion_1d(state: ParticleState, mask=None):
    """Mass-weighted 1-D velocity dispersion about the (masked) mean
    velocity, sqrt(sum m |v - v_bar|^2 / (3 sum m)); NaN for zero mass."""
    m = _f64(state.mass)
    if mask is not None:
        m = m * mask
    msum = torch.sum(m)
    vel = _f64(state.vel)
    vb = torch.sum(vel * m[:, None], dim=0) / torch.clamp(msum, min=1e-300)
    s2 = torch.sum(m * torch.sum((vel - vb) ** 2, dim=1))
    return torch.where(
        msum > 0, torch.sqrt(s2 / (3.0 * torch.clamp(msum, min=1e-300))),
        math.nan)


def half_mass_relaxation_time(n_bound, m_bound, r_half, G,
                              gamma: float = 0.11):
    """Spitzer–Hart t_rh = 0.138 N^{1/2} r_h^{3/2} / ((G m_bar)^{1/2}
    ln(gamma N)) with bound N, mean mass and half-mass radius; NaN when
    N_bound < 2 or ln(gamma N) <= 0."""
    nb = _f64(n_bound)
    mbar = _f64(m_bound) / torch.clamp(nb, min=1.0)
    lnl = torch.log(torch.clamp(gamma * nb, min=1e-300))
    t = (0.138 * torch.sqrt(nb) * _f64(r_half) ** 1.5
         / torch.sqrt(G * torch.clamp(mbar, min=1e-300))
         / torch.clamp(lnl, min=1e-300))
    return torch.where((nb >= 2) & (lnl > 0), t, math.nan)


def bound_mass_energy(state: ParticleState, force: ForceModel,
                      n_iter: int = 8, phi_pair=None):
    """Bound mass via an iterated energy cut in the cluster frame: a star
    is bound if 0.5 |v - v_b|^2 + phi_pair(x) < 0, with v_b the mean
    velocity of the currently bound stars. Returns (M_bound, N_bound,
    mask)."""
    force = force.at_time(state.time)
    m = _f64(state.mass)
    if phi_pair is None:
        _, phi_pair, _ = force.accel_potential(state.pos, state.mass)
    phi_pair = _f64(phi_pair)
    vel = _f64(state.vel)
    mask = torch.ones_like(m)
    for _ in range(n_iter):
        w = m * mask
        vb = torch.sum(vel * w[:, None], dim=0) / torch.clamp(torch.sum(w),
                                                             min=1e-300)
        ke = 0.5 * torch.sum((vel - vb) ** 2, dim=1)
        mask = _f64(ke + phi_pair < 0)
    return torch.sum(m * mask), torch.sum(mask).to(torch.int64), mask


def tidal_radius(m_bound, tidal_coeff, G):
    """King tidal radius r_t = (G M_b / (Ω² − ∂²Φ/∂R²))^{1/3}; inf (no
    truncation) for a non-positive coefficient."""
    r = (G * m_bound / torch.clamp(tidal_coeff, min=1e-300)) ** (1.0 / 3.0)
    return torch.where(tidal_coeff > 0, r, math.inf)


def bound_mass_tidal(state: ParticleState, force: ForceModel,
                     n_iter: int = 20, center=None, center_vel=None):
    """Bound mass via the iterative tidal-radius cut: iterate
    r_t = (G M_b / λ)^{1/3}, M_b = mass inside r_t, with λ = λ_max(T) + Ω²
    from the full autodiff tidal tensor at the cluster centre and the
    instantaneous orbital Ω² = |r×v|²/r⁴. Returns (M_bound, N_bound, r_t,
    mask)."""
    force = force.at_time(state.time)
    m = _f64(state.mass)
    n = state.n
    if force.external is None:
        return (torch.sum(m),
                torch.tensor(n, dtype=torch.int64, device=state.device),
                torch.tensor(math.inf, dtype=_F64, device=state.device),
                torch.ones((n,), dtype=_F64, device=state.device))
    if center is None:
        center = density_center(state)
    d = torch.linalg.norm(_f64(state.pos) - center, dim=1)
    if center_vel is None:
        center_vel = torch.sum(_f64(state.vel) * m[:, None], dim=0) \
            / torch.sum(m)
    r2 = torch.sum(center ** 2)
    omega2 = torch.sum(torch.linalg.cross(center, center_vel) ** 2) \
        / torch.clamp(r2 * r2, min=1e-300)
    lam = force.external.tidal_coefficient_at(center, omega2)
    m_b = torch.sum(m)
    for _ in range(n_iter):
        m_b = torch.sum(m * (d < tidal_radius(m_b, lam, force.G)))
    r_t = tidal_radius(m_b, lam, force.G)
    mask = _f64(d < r_t)
    return m_b, torch.sum(mask).to(torch.int64), r_t, mask


def compute_all(state: ParticleState, force: ForceModel,
                fractions=(0.1, 0.25, 0.5, 0.75, 0.9),
                core: bool = True) -> dict:
    """The full diagnostics row: 0-d device tensors, plus ``time`` as a
    host float. One pairwise-potential pass, shared by the energies and the
    bound-mass energy cut. ``core=True`` adds the CH85 columns (r_core,
    rho_core): a second bounded O(min(N, 65536)²) distance sweep."""
    force = force.at_time(state.time)
    _, phi_pair, phi_ext = force.accel_potential(state.pos, state.mass)
    e = energies(state, force, precomputed_phi=(phi_pair, phi_ext))
    center = density_center(state)
    L = angular_momentum(state)
    if force.external is not None:
        m_b, n_b, r_t, mask = bound_mass_tidal(state, force, center=center)
    else:
        m_b, n_b, mask = bound_mass_energy(state, force, phi_pair=phi_pair)
        r_t = torch.tensor(math.inf, dtype=_F64, device=state.device)
    rl = lagrangian_radii(state, fractions, center=center, mask=mask)
    out = dict(e)
    out.update({
        "time": state.time,
        "Lx": L[0], "Ly": L[1], "Lz": L[2],
        "L_norm": torch.linalg.norm(L),
        "M_bound": m_b,
        "N_bound": n_b,
        "r_tidal": r_t,
        "cx": center[0], "cy": center[1], "cz": center[2],
    })
    for f, r in zip(fractions, rl):
        out[f"r_lagr_{int(round(f * 100))}"] = r

    # bound-internal virial ratio: KE about the bound COM velocity over |W|
    # with W = half the bound-mass-weighted pairwise potential (the unbound
    # tail contributes to phi but sits far away). Q ~ 0.5 in equilibrium.
    m64, vel64 = _f64(state.mass), _f64(state.vel)
    wb = m64 * mask
    wb_sum = torch.sum(wb)
    wsum = torch.clamp(wb_sum, min=1e-300)
    vb = torch.sum(vel64 * wb[:, None], dim=0) / wsum
    ke_b = 0.5 * torch.sum(wb * torch.sum((vel64 - vb) ** 2, dim=1))
    w_b = 0.5 * torch.sum(wb * _f64(phi_pair))
    alive = wb_sum > 0
    out["Q_virial"] = torch.where(
        alive, ke_b / torch.clamp(torch.abs(w_b), min=1e-300), math.nan)
    # sigma_1d = sqrt(2 KE_b / (3 M_b)), from the same sums
    out["sigma_1d"] = torch.where(
        alive, torch.sqrt(2.0 * ke_b / (3.0 * wsum)), math.nan)
    fr = tuple(fractions)
    r_half = (rl[fr.index(0.5)] if 0.5 in fr else
              lagrangian_radii(state, (0.5,), center=center, mask=mask)[0])
    out["t_rh"] = half_mass_relaxation_time(n_b, m_b, r_half, force.G)
    if core:
        # resolution floor 2·eps: sub-softening densities are unresolved
        out["r_core"], out["rho_core"] = core_radius_density(
            state, center=center, mask=mask, r_min=2.0 * force.eps)
    return out
