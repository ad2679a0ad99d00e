"""Softened direct-summation gravity in plain PyTorch: the port's reference
ops (counterpart of ``oc_nbody_tpu/ops/gravity.py``).

Two tiers, as in the JAX package:
  * ``*_direct`` — the full (N, N) broadcast in the input dtype; the oracle,
    for small N and tests only.
  * ``*_rows`` and the single-device wrappers — blocked over rows so memory
    stays O(chunk * N); the pairwise math runs in the input dtype (f32 on
    the production path, f64 where a caller wants an oracle at large N).

The hand-written CUDA kernels (``ops/cuda_gravity.py``) compute the same
functions; on CPU tensors their wrappers call these.

Conventions: r_ij = x_j - x_i points at the source;
  a_i   = G sum_j m_j r_ij / (r_ij² + eps²)^{3/2}
  phi_i = -G sum_{j != i} m_j / sqrt(r_ij² + eps²)
The ``*_rows`` potential still holds the softened self term -G m_i/eps when
rows overlap sources; callers remove it with ``self_phi``. Separations use
direct subtraction on coordinates centred before the f32 cast
(``prepare_f32``), and u = r² + eps² is guarded so eps == 0 self pairs give
0, not NaN.
"""
from __future__ import annotations

import torch


def rounded(x, dtype) -> float:
    """A host scalar rounded to ``dtype`` (so f32 math sees f32 operands)."""
    return float(torch.tensor(x, dtype=dtype))


def _inv_r(u):
    tiny = torch.finfo(u.dtype).tiny
    return torch.where(u > 0, torch.rsqrt(torch.clamp(u, min=tiny)), 0.0)


# --------------------------------------------------------------------------
# oracle tier: full broadcast, input dtype
# --------------------------------------------------------------------------

def _pair_geometry(pos, eps):
    dr = pos[None, :, :] - pos[:, None, :]
    u = torch.sum(dr * dr, dim=-1) + eps * eps
    return dr, _inv_r(u)


def accel_direct(pos, mass, eps=0.0, G=1.0):
    """Oracle acceleration, full (N, N) broadcast in pos.dtype."""
    mass = mass.to(pos.dtype)
    dr, inv_r = _pair_geometry(pos, eps)
    w = G * mass[None, :] * inv_r**3
    return torch.sum(w[:, :, None] * dr, dim=1)  # self term: w_ii * 0 = 0


def accel_potential_direct(pos, mass, eps=0.0, G=1.0):
    """Oracle (accel, per-particle potential phi_i), excluding self terms."""
    mass = mass.to(pos.dtype)
    dr, inv_r = _pair_geometry(pos, eps)
    w = G * mass[None, :] * inv_r**3
    acc = torch.sum(w[:, :, None] * dr, dim=1)
    phi = -G * torch.sum(mass[None, :] * inv_r, dim=1)
    return acc, phi + self_phi(mass, eps, G)


def self_phi(mass, eps, G):
    """The softened self-interaction potential -G m_i/eps that a rows == src
    sum includes and must be removed (zero when eps == 0)."""
    eps = rounded(eps, mass.dtype)
    inv_eps = rounded(1.0 / eps, mass.dtype) if eps > 0 else 0.0
    return G * mass * inv_eps


# --------------------------------------------------------------------------
# rows-vs-sources tier, blocked over rows
# --------------------------------------------------------------------------

def _block(src_pos, gm, pi, eps2, with_phi):
    dx = src_pos[None, :, 0] - pi[:, 0:1]
    dy = src_pos[None, :, 1] - pi[:, 1:2]
    dz = src_pos[None, :, 2] - pi[:, 2:3]
    u = dx * dx + dy * dy + dz * dz + eps2
    inv_r = _inv_r(u)
    gminv = gm * inv_r
    w = gminv * inv_r * inv_r
    acc = torch.stack([torch.sum(w * dx, dim=1), torch.sum(w * dy, dim=1),
                       torch.sum(w * dz, dim=1)], dim=1)
    return acc, (-torch.sum(gminv, dim=1) if with_phi else None)


def _rows(pos_rows, src_pos, src_mass, eps, G, chunk, with_phi):
    dtype = pos_rows.dtype
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    gm = (rounded(G, dtype) * src_mass.to(dtype))[None, :]
    blocks = [_block(src_pos, gm, pos_rows[i0:i0 + chunk], eps2, with_phi)
              for i0 in range(0, pos_rows.shape[0], chunk)]
    acc = torch.cat([b[0] for b in blocks]) if blocks else \
        pos_rows.new_zeros((0, 3))
    if not with_phi:
        return acc
    phi = torch.cat([b[1] for b in blocks]) if blocks else \
        pos_rows.new_zeros((0,))
    return acc, phi


def accel_rows(pos_rows, src_pos, src_mass, eps, G=1.0, chunk: int = 1024):
    """Accel on ``pos_rows`` from ``src_pos/src_mass``, all already centred,
    computed in pos_rows.dtype."""
    return _rows(pos_rows, src_pos, src_mass, eps, G, chunk, False)


def accel_potential_rows(pos_rows, src_pos, src_mass, eps, G=1.0,
                         chunk: int = 1024):
    """(accel, phi) on rows from sources. phi still contains the softened
    self term when rows overlap sources — caller adds ``self_phi``."""
    return _rows(pos_rows, src_pos, src_mass, eps, G, chunk, True)


# --------------------------------------------------------------------------
# single-device wrappers: centre -> cast -> rows == sources -> cast back
# --------------------------------------------------------------------------

def prepare_f32(pos, mass, compute_dtype=torch.float32):
    """Centre on the mean position and cast for the pair sum. Pairwise
    differences are shift-invariant, so centring costs nothing physically
    but keeps the f32 mantissa for a cluster far from the origin (the north
    star sits 8 kpc out)."""
    pos_c = (pos - torch.mean(pos, dim=0)).to(compute_dtype)
    return pos_c.contiguous(), mass.to(compute_dtype).contiguous()


def accel(pos, mass, eps=0.0, G=1.0, *, compute_dtype=torch.float32,
          chunk=1024):
    """Blocked pairwise acceleration; returns (N, 3) in pos.dtype."""
    pos_c, mass_c = prepare_f32(pos, mass, compute_dtype)
    return accel_rows(pos_c, pos_c, mass_c, eps, G, chunk).to(pos.dtype)


def accel_potential(pos, mass, eps=0.0, G=1.0, *,
                    compute_dtype=torch.float32, chunk=1024):
    """Blocked (accel, phi); self term removed."""
    pos_c, mass_c = prepare_f32(pos, mass, compute_dtype)
    acc, phi = accel_potential_rows(pos_c, pos_c, mass_c, eps, G, chunk)
    phi = phi + self_phi(mass_c, eps, G)
    return acc.to(pos.dtype), phi.to(pos.dtype)
