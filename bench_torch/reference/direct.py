"""The softened direct sum over every ordered pair, in plain PyTorch.

With d_ij = x_j - x_i, w_ij = v_j - v_i and u_ij = |d_ij|^2 + eps^2:

  a_i   = G sum_{j != i} m_j d_ij / u_ij^(3/2)
  phi_i = -G sum_{j != i} m_j / u_ij^(1/2)
  j_i   = G sum_{j != i} m_j (w_ij - 3 (d_ij . w_ij) d_ij / u_ij) / u_ij^(3/2)

Positions and velocities are centred in float64 (the sums are
shift-invariant) and then computed in ``dtype``: float64 for the
reference. The control passes a lower precision, whose pair terms are
summed in ``sum_dtype``. Rows go in blocks of ``block``, so the
temporaries hold block x N values.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def pair_sums(pos, mass, eps: float, G: float, vel=None, dtype=F64,
              sum_dtype=None, block: int = 256):
    """(acc, phi, jerk) as float64 tensors on ``pos``'s device; ``jerk`` is
    None without ``vel``."""
    sum_dtype = sum_dtype or dtype
    x = (pos.to(F64) - pos.to(F64).mean(dim=0)).to(dtype)
    m = mass.to(F64).to(dtype)
    v = None
    if vel is not None:
        v = (vel.to(F64) - vel.to(F64).mean(dim=0)).to(dtype)
    eps2 = torch.tensor(eps * eps, dtype=dtype, device=x.device)
    gm = (G * m)[None, :]
    n = x.shape[0]
    acc = torch.empty((n, 3), dtype=F64, device=x.device)
    phi = torch.empty((n,), dtype=F64, device=x.device)
    jerk = (torch.empty((n, 3), dtype=F64, device=x.device)
            if v is not None else None)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        rows = torch.arange(i1 - i0, device=x.device)
        d = x[None, :, :] - x[i0:i1, None, :]                 # (b, N, 3)
        u = torch.sum(d * d, dim=-1) + eps2
        inv = torch.rsqrt(u)
        inv[rows, rows + i0] = 0.0                             # j == i
        inv3 = inv * inv * inv
        phi[i0:i1] = -torch.sum((gm * inv).to(sum_dtype), dim=1).to(F64)
        acc[i0:i1] = torch.sum(((gm * inv3)[..., None] * d).to(sum_dtype),
                               dim=1).to(F64)
        if v is not None:
            w = v[None, :, :] - v[i0:i1, None, :]
            rv = torch.sum(d * w, dim=-1) * inv * inv
            term = (gm * inv3)[..., None] * (w - 3.0 * rv[..., None] * d)
            jerk[i0:i1] = torch.sum(term.to(sum_dtype), dim=1).to(F64)
    return acc, phi, jerk


def energies(pos, vel, mass, phi_pair, phi_ext=None) -> dict:
    """Kinetic, pair and external energies, the total and the cluster's
    internal energy (kinetic about the centre-of-mass velocity plus the
    pair energy), as host floats in float64."""
    m = mass.to(F64)
    v = vel.to(F64)
    ke = 0.5 * torch.sum(m * torch.sum(v * v, dim=1))
    vbar = torch.sum(v * m[:, None], dim=0) / torch.sum(m)
    ke_int = 0.5 * torch.sum(m * torch.sum((v - vbar) ** 2, dim=1))
    pe = 0.5 * torch.sum(m * phi_pair.to(F64))
    e_ext = (torch.sum(m * phi_ext.to(F64)) if phi_ext is not None
             else torch.zeros((), dtype=F64, device=m.device))
    return {"KE": float(ke), "PE_pair": float(pe), "E_ext": float(e_ext),
            "E_tot": float(ke + pe + e_ext), "E_int": float(ke_int + pe)}


def centre_of_mass(pos, vel, mass):
    """(position, velocity) of the centre of mass, float64 (3,) tensors."""
    m = mass.to(F64)
    msum = torch.sum(m)
    return (torch.sum(pos.to(F64) * m[:, None], dim=0) / msum,
            torch.sum(vel.to(F64) * m[:, None], dim=0) / msum)
