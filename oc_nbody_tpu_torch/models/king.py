"""King (1966) lowered-isothermal initial conditions (counterpart of
``oc_nbody_tpu/models/king.py``).

Built on the host with numpy and scipy, once, off the hot path, with the
JAX package's recipe and random stream (``np.random.default_rng(seed)``):

  1. Integrate the dimensionless King Poisson equation
         W'' + (2/r) W' = -9 rho(W)/rho(W0),   W(0)=W0, W'(0)=0,
     (r in core radii) outward until W -> 0; that radius is the tidal
     radius r_t. rho(W) = e^W erf(sqrt(W)) - sqrt(4W/pi) (1 + 2W/3).
  2. Sample radii by inverse CDF of the cumulative mass M(<r).
  3. Sample speeds at each radius by vectorised rejection from the lowered
     Maxwellian f(v) ∝ v^2 (e^{W - v^2/2} - 1), v < v_esc = sqrt(2W)
     (sigma = 1 units).
  4. Hénon-rescale to M=1, E=-1/4, G=1 (virial radius 1), then apply
     (total_mass, G, r_scale).

The exact pairwise PE of step 4 is the port's own plain f64 sum
(``ops/gravity.py``), so for one seed the IC equals the JAX package's up
to the rounding of that sum.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import solve_ivp
from scipy.special import erf

from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.state import ParticleState, make_state


def _rho_w(w):
    """Dimensionless King density; rho(W)/rho_1 with sigma = 1."""
    w = np.maximum(w, 0.0)
    sq = np.sqrt(w)
    return np.where(
        w > 0,
        np.exp(w) * erf(sq) - np.sqrt(4.0 * w / np.pi) * (1.0 + 2.0 * w / 3.0),
        0.0,
    )


def solve_king_profile(w0: float, r_max: float = 1e4):
    """Integrate the King ODE; returns dict with r, W, rho, M(<r), r_t.

    r is in King core radii; densities in units of the central density.
    """
    rho0 = float(_rho_w(np.asarray(w0)))

    def rhs(r, y):
        w, dw = y
        d2w = -9.0 * _rho_w(w) / rho0 - (2.0 / r) * dw if r > 0 else -3.0
        return [dw, d2w]

    def hit_zero(r, y):
        return y[0]

    hit_zero.terminal = True
    hit_zero.direction = -1

    # series start near r = 0
    r0 = 1e-6
    y0 = [w0 - 1.5 * r0**2, -3.0 * r0]
    sol = solve_ivp(rhs, (r0, r_max), y0, events=hit_zero, rtol=1e-10,
                    atol=1e-12, dense_output=True, max_step=0.1)
    if sol.t_events[0].size == 0:
        raise RuntimeError(f"King ODE did not reach W=0 for W0={w0}")
    r_t = float(sol.t_events[0][0])

    r = np.linspace(r0, r_t, 4096)
    W = sol.sol(r)[0]
    W = np.maximum(W, 0.0)
    rho = _rho_w(W) / rho0
    integrand = 4.0 * np.pi * r**2 * rho
    M = np.concatenate([[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1])
                                         * np.diff(r))])
    return {"r": r, "W": W, "rho": rho, "M": M, "r_t": r_t, "rho0": rho0}


def _sample_speeds(rng, W_i):
    """Rejection-sample speeds (sigma=1) from f(v) ∝ v^2 (e^{W-v^2/2}-1)."""
    n = W_i.shape[0]
    v = np.zeros(n)
    todo = np.ones(n, bool)
    vesc = np.sqrt(2.0 * W_i)
    # envelope: uniform box [0, vesc] x [0, fmax]; fmax on a small v-grid
    grid = np.linspace(0.0, 1.0, 64)[None, :] * vesc[:, None]
    fgrid = grid**2 * np.expm1(W_i[:, None] - 0.5 * grid**2)
    fmax = 1.05 * np.maximum(fgrid.max(axis=1), 1e-300)
    for _ in range(1000):
        if not todo.any():
            break
        idx = np.nonzero(todo)[0]
        vc = rng.uniform(0.0, vesc[idx])
        uc = rng.uniform(0.0, fmax[idx])
        f = vc**2 * np.expm1(W_i[idx] - 0.5 * vc**2)
        ok = uc < f
        v[idx[ok]] = vc[ok]
        todo[idx[ok]] = False
    if todo.any():
        raise RuntimeError("King speed sampling failed to converge")
    return v


def _isotropic_np(rng, n):
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)


def king(n: int, w0: float, seed: int = 0, total_mass: float = 1.0,
         G: float = 1.0, r_scale: float = 1.0, masses=None,
         device=None) -> ParticleState:
    """Sample an N-particle King model, Hénon-scaled (virial radius = 1
    before ``r_scale``), in virial equilibrium.

    Args:
      n: particle count.  w0: concentration W0 (typical 3-12).
      seed: numpy RNG seed (deterministic; the JAX package's stream).
      total_mass, G, r_scale: final scaling of the Hénon-unit sample.
      masses: optional per-particle masses (rescaled to total_mass).
      device: where the state lives (the IC is built on the host).
    """
    rng = np.random.default_rng(seed)
    prof = solve_king_profile(w0)

    # radii by inverse CDF of M(<r)
    u = rng.uniform(0.0, 1.0, n) * prof["M"][-1]
    r_i = np.interp(u, prof["M"], prof["r"])
    W_i = np.interp(r_i, prof["r"], prof["W"])
    pos = r_i[:, None] * _isotropic_np(rng, n)

    v_i = _sample_speeds(rng, W_i)
    vel = v_i[:, None] * _isotropic_np(rng, n)

    if masses is None:
        m = np.full(n, 1.0 / n)
    else:
        m = np.asarray(masses, np.float64)
        m = m / m.sum()

    # centre of mass removal
    pos -= (pos * m[:, None]).sum(0) / m.sum()
    vel -= (vel * m[:, None]).sum(0) / m.sum()

    # Hénon rescale (G=1): measure KE and exact PE, then set KE=1/4, PE=-1/2
    ke = 0.5 * (m * (vel**2).sum(1)).sum()
    pe = _potential_energy_np(pos, m)
    alpha = pe / (-0.5)          # pos scale: PE' = PE/alpha = -1/2
    beta = np.sqrt(0.25 / ke)    # vel scale: KE' = beta^2 KE = 1/4
    pos *= alpha
    vel *= beta

    # final unit scaling: mass M, radius r_scale, G arbitrary
    v_unit = np.sqrt(G * total_mass / r_scale)
    return make_state(torch.from_numpy(pos * r_scale),
                      torch.from_numpy(vel * v_unit),
                      torch.from_numpy(m * total_mass), device=device)


def _potential_energy_np(pos, m, chunk: int = 512):
    """Exact (unsoftened, f64) pairwise PE of host arrays, through the
    port's blocked plain op on the CPU: ``gravity.potential``, whose phi is
    ``accel_potential``'s bit for bit without the acceleration sums (1.7x
    faster on the CPU; O(N^2), over a minute at N = 65,536)."""
    pos_t = torch.from_numpy(np.asarray(pos, np.float64))
    m_t = torch.from_numpy(np.asarray(m, np.float64))
    phi = gravity.potential(pos_t, m_t, 0.0, 1.0,
                            compute_dtype=torch.float64, chunk=chunk)
    return 0.5 * float(torch.sum(m_t * phi))
