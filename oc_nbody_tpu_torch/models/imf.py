"""Initial mass function sampling by inverse CDF (counterpart of
``oc_nbody_tpu/models/imf.py``).

The Kroupa (2001) broken power law dN/dm ∝ m^-alpha with
  alpha = 0.3 for m in [0.01, 0.08) Msun
  alpha = 1.3 for m in [0.08, 0.5) Msun
  alpha = 2.3 for m in [0.5, m_max] Msun
is sampled exactly by inverting the piecewise-analytic CDF — vectorised,
no rejection. The uniforms come from a ``torch.Generator``; the inversion
(``inverse_cdf``) is a function of the uniforms alone, so the same uniforms
give the JAX package's masses.
"""
from __future__ import annotations

import math

import torch

KROUPA_BREAKS = (0.08, 0.5)
KROUPA_ALPHAS = (0.3, 1.3, 2.3)


def _segment_integrals(edges, alphas):
    """Integral of m^-alpha over each [edges[i], edges[i+1]] with continuity
    coefficients c_i such that the density is continuous at the breaks."""
    coeffs = [1.0]
    for i in range(1, len(alphas)):
        # continuity at edges[i]: c_{i-1} e^-a_{i-1} = c_i e^-a_i
        coeffs.append(coeffs[-1] * edges[i] ** (alphas[i] - alphas[i - 1]))
    integrals = []
    for i, a in enumerate(alphas):
        lo, hi = edges[i], edges[i + 1]
        p = 1.0 - a
        if p == 0.0:  # alpha == 1: the integral is logarithmic
            integrals.append(coeffs[i] * math.log(hi / lo))
        else:
            integrals.append(coeffs[i] * (hi**p - lo**p) / p)
    return coeffs, integrals


def inverse_cdf(u, edges, alphas):
    """Masses at the unit uniforms ``u`` (a float tensor in [0, 1)) under
    the broken power law with segment ``edges`` and slopes ``alphas``;
    computed in u.dtype."""
    dtype = u.dtype
    coeffs, integrals = _segment_integrals(edges, alphas)
    integrals = torch.tensor(integrals, dtype=torch.float64)
    cdf = torch.cat([torch.zeros(1, dtype=torch.float64),
                     torch.cumsum(integrals, 0)])
    total = float(cdf[-1])
    cdf = cdf.to(dtype=dtype, device=u.device)
    u = u * total
    seg = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0,
                      len(alphas) - 1)

    def table(values):
        return torch.tensor(values, dtype=dtype, device=u.device)[seg]

    p = 1.0 - table(alphas)
    lo = table(edges[:-1])
    # invert: u - cdf[seg] = c (m^p - lo^p)/p, or c log(m/lo) when p == 0
    # (alpha == 1); p is exact so the p == 0 select is exact too.
    frac = (u - cdf[seg]) / table(coeffs)
    p_safe = torch.where(p == 0.0, 1.0, p)
    m_pow = (lo**p_safe + frac * p_safe) ** (1.0 / p_safe)
    m_log = lo * torch.exp(frac)
    return torch.where(p == 0.0, m_log, m_pow)


def kroupa_segments(m_min: float, m_max: float):
    """(edges, alphas) of the Kroupa (2001) power law cut to [m_min,
    m_max]."""
    if not (0.0 < m_min < m_max):
        raise ValueError("need 0 < m_min < m_max")
    seg_bounds = [0.0, *KROUPA_BREAKS, float("inf")]
    edges, alphas = [m_min], []
    for i, alpha in enumerate(KROUPA_ALPHAS):
        lo = max(seg_bounds[i], m_min)
        hi = min(seg_bounds[i + 1], m_max)
        if lo < hi:
            alphas.append(alpha)
            edges.append(hi)
    return tuple(edges), tuple(alphas)


def kroupa_imf(n: int, gen: torch.Generator, m_min: float = 0.08,
               m_max: float = 100.0, dtype=torch.float64) -> torch.Tensor:
    """Sample n stellar masses [Msun] from the Kroupa (2001) IMF.

    The standard open-cluster default range is [0.08, 100] Msun; pass
    m_min=0.01 to include brown dwarfs.
    """
    edges, alphas = kroupa_segments(m_min, m_max)
    u = torch.rand(n, generator=gen, dtype=dtype)
    return inverse_cdf(u, edges, alphas)


def salpeter_imf(n: int, gen: torch.Generator, m_min: float = 0.4,
                 m_max: float = 10.0, alpha: float = 2.35,
                 dtype=torch.float64) -> torch.Tensor:
    """Single power-law (Salpeter 1955) IMF, for comparison runs."""
    u = torch.rand(n, generator=gen, dtype=dtype)
    return inverse_cdf(u, (m_min, m_max), (alpha,))
