"""The diagnostics row's structure columns, in plain PyTorch: the density
centre, the bound mass and tidal radius of the iterative tidal cut, the
Lagrangian radii of the bound stars and the Casertano & Hut (1985) core.

The definitions the row states:

  centre    shrinking sphere: from the centre of mass and the largest
            distance r, 24 times: while the mass within r stays above 5% of
            the total, move to the centre of that mass and shrink r by 0.9.
  lambda    the largest eigenvalue of the tidal tensor -d2(phi)/dx_i dx_j
            of the external field at the centre, plus the orbit's
            Omega^2 = |c x v|^2 / |c|^4 (v: the mean velocity of all stars).
  M_bound   from the total mass, 20 times: the mass within the tidal radius
            r_t = (G M_bound / lambda)^(1/3); N_bound counts those stars.
            Without an external field, no tidal radius: from all stars, 8
            times, a star is bound where 0.5 |v - v_b|^2 + phi_pair < 0, v_b
            the mean velocity of the stars bound so far.
  r_lagr_f  the smallest radius about the centre at which the cumulative
            mass of the bound stars, taken by radius, reaches f of theirs.
  CH85      on every ``ps``-th star (probes) against every ``ss``-th
            (sources, masses times ``ss``), ps and ss the least strides
            that leave 65,536 or fewer: rho_j = (mass of the k-1 nearest
            sources) / (4 pi/3 r_k^3), r_k the k-th nearest source other than
            the probe itself (k = 6), floored at 2 eps; over the bound
            probes r_core = sqrt(sum rho^2 r^2 / sum rho^2) and
            rho_core = sum rho^2 / sum rho.

Positions and velocities are taken about their plain mean in float64 (every
column is shift-invariant but the field's, which is evaluated in float64 at
the centre) and then computed in ``dtype``: float64 for the reference. The
control passes a lower precision, whose reductions run in ``sum_dtype``.
Probes go in blocks of ``block`` against all sources.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64
K_CH85 = 6
MAX_SAMPLE = 65536


def structure(pos, vel, mass, field, G: float, eps: float, fractions,
              core: bool = True, dtype=F64, sum_dtype=None,
              block: int = 512, phi_pair=None) -> dict:
    """{'M_bound', 'N_bound', 'r_tidal', 'r_lagr': [...], 'r_core',
    'rho_core'} as host floats of the state (pos, vel, mass) under the
    external ``field`` (None: the energy cut on ``phi_pair``, each star's
    pair potential, and no tidal radius)."""
    sum_dtype = sum_dtype or dtype
    origin = pos.to(F64).mean(dim=0)
    v_origin = vel.to(F64).mean(dim=0)
    x = (pos.to(F64) - origin).to(dtype)
    v = (vel.to(F64) - v_origin).to(dtype)
    m = mass.to(F64).to(dtype)

    def total(t, dim=0):
        return torch.sum(t.to(sum_dtype), dim=dim)

    m_tot = total(m)
    c = _centre(x, m, total, m_tot)
    d = torch.linalg.vector_norm(x - c, dim=1)
    out = {}
    if field is None:
        m_b, bound = _energy_cut(v, m, phi_pair.to(dtype), total)
        out["M_bound"] = float(m_b)
        out["r_tidal"] = math.inf
    else:
        centre = origin + c.to(F64)
        v_mean = v_origin + (total(m[:, None] * v) / m_tot).to(F64)
        lam = _tidal_coefficient(field, centre, v_mean)
        m_b = m_tot
        for _ in range(20):
            m_b = total(m * (d < _tidal_radius(m_b, lam, G)))
        r_t = _tidal_radius(m_b, lam, G)
        bound = d < r_t
        out["M_bound"] = float(m_b)
        out["r_tidal"] = float(r_t)
    out["N_bound"] = int(bound.sum())
    out["r_lagr"] = _lagrangian(d, m * bound, fractions, sum_dtype)
    if core:
        out["r_core"], out["rho_core"] = _core(x, m, c, bound, eps, dtype,
                                               sum_dtype, block)
    return out


def _centre(x, m, total, m_tot, n_iter: int = 24, shrink: float = 0.9,
            min_frac: float = 0.05):
    c = total(x * m[:, None]) / m_tot
    c = c.to(x.dtype)
    r = torch.linalg.vector_norm(x - c, dim=1).max()
    for _ in range(n_iter):
        inside = torch.linalg.vector_norm(x - c, dim=1) < r
        w = m * inside
        w_sum = total(w)
        if not bool(w_sum > min_frac * m_tot):
            break
        c = (total(x * w[:, None]) / w_sum).to(x.dtype)
        r = r * shrink
    return c


def _energy_cut(v, m, phi, total, n_iter: int = 8):
    """(M_bound, bound): the iterated energy cut in the frame of the bound
    stars' mean velocity."""
    bound = torch.ones_like(m, dtype=torch.bool)
    for _ in range(n_iter):
        w = m * bound
        v_b = (total(v * w[:, None]) / total(w)).to(v.dtype)
        ke = 0.5 * torch.sum((v - v_b) ** 2, dim=1)
        bound = ke + phi < 0
    return total(m * bound), bound


def _tidal_coefficient(field, centre, v_mean) -> float:
    """lambda_max(-Hess phi) at ``centre`` plus Omega^2, in float64."""
    hess = torch.autograd.functional.hessian(field.phi, centre.cpu())
    lam = float(torch.linalg.eigvalsh(-hess)[-1])
    c, v = centre.cpu(), v_mean.cpu()
    r2 = float(torch.sum(c * c))
    omega2 = float(torch.sum(torch.linalg.cross(c, v) ** 2)) / (r2 * r2)
    return lam + omega2


def _tidal_radius(m_b, lam: float, G: float):
    if lam <= 0:
        return torch.full_like(m_b, math.inf)
    return (G * m_b / lam) ** (1.0 / 3.0)


def _lagrangian(d, w, fractions, sum_dtype) -> list:
    r, order = torch.sort(d)
    csum = torch.cumsum(w[order].to(sum_dtype), dim=0)
    out = []
    for f in fractions:
        if float(csum[-1]) <= 0:
            out.append(math.nan)
            continue
        i = int(torch.count_nonzero(csum < f * csum[-1]))
        out.append(float(r[min(i, r.shape[0] - 1)]))
    return out


def _core(x, m, c, bound, eps: float, dtype, sum_dtype, block: int):
    """(r_core, rho_core) of the CH85 local densities."""
    n = x.shape[0]
    k = K_CH85
    if n <= k + 1:
        return math.nan, math.nan
    ps = -(-n // MAX_SAMPLE)
    ss = -(-n // MAX_SAMPLE)
    xc = x - c
    probes, p_idx = xc[::ps], torch.arange(0, n, ps, device=x.device)
    src, s_idx = xc[::ss], torch.arange(0, n, ss, device=x.device)
    m_src = m[::ss] * ss
    r_min = torch.tensor(2.0 * eps, dtype=dtype, device=x.device)
    far = torch.tensor(math.inf, dtype=dtype, device=x.device)
    rho = torch.empty(probes.shape[0], dtype=F64, device=x.device)
    for i0 in range(0, probes.shape[0], block):
        p = probes[i0:i0 + block]
        d2 = ((p[:, None, 0] - src[None, :, 0]) ** 2
              + (p[:, None, 1] - src[None, :, 1]) ** 2
              + (p[:, None, 2] - src[None, :, 2]) ** 2)
        d2 = torch.where(p_idx[i0:i0 + block, None] == s_idx[None, :], far,
                         d2)
        near, j = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        m_near = torch.sum(m_src[j[:, :k - 1]].to(sum_dtype), dim=1)
        r_k = torch.maximum(torch.sqrt(near[:, k - 1]), r_min)
        vol = (4.0 * math.pi / 3.0) * r_k.to(sum_dtype) ** 3
        rho[i0:i0 + block] = (m_near / vol).to(F64)
    rho = rho * bound[::ps]
    r2 = torch.sum((probes.to(sum_dtype)) ** 2, dim=1).to(F64)
    w = rho * rho
    if float(rho.sum()) <= 0:
        return math.nan, math.nan
    return (float(torch.sqrt(torch.sum(w * r2) / torch.sum(w))),
            float(torch.sum(w) / torch.sum(rho)))
