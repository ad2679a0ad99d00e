"""Softened direct-summation gravity in plain PyTorch: the port's reference
ops (counterpart of ``oc_nbody_tpu/ops/gravity.py``).

Two tiers, as in the JAX package:
  * ``*_direct`` — the full (N, N) broadcast in the input dtype; the oracle,
    for small N and tests only.
  * ``*_rows`` and the single-device wrappers — blocked over rows so memory
    stays O(chunk * N); the pairwise math runs in the input dtype (f32 on
    the production path, f64 where a caller wants an oracle at large N).

A third tier, ``*_cross_pair``, sums two disjoint sets in one sweep (each
pair once, A's action and B's reaction).

The hand-written CUDA kernels (``ops/cuda_gravity.py``) compute the same
functions; on CPU tensors their wrappers call these. The operands of the
extended (hi/lo) precision tier are prepared here too (``split_hilo``,
``centre_split``, ``gm_f32``, ``prepare_x``); its pair sums are in
``ops/df32.py``. ``potential`` is the pair potential alone, the f64
diagnostics sum's plain twin.

Conventions: r_ij = x_j - x_i points at the source, v_ij = v_j - v_i;
  a_i   = G sum_j m_j r_ij / (r_ij² + eps²)^{3/2}
  phi_i = -G sum_{j != i} m_j / sqrt(r_ij² + eps²)
  j_i   = G sum_j m_j [v_ij - 3 (r_ij·v_ij) r_ij / (r_ij² + eps²)]
          / (r_ij² + eps²)^{3/2}
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
    """The zero guard: 0 where u is below the dtype's least normal number.
    The JAX ``_inv_r`` is u > 0 ? rsqrt(max(u, tiny)) : 0 on arithmetic that
    flushes a subnormal u to 0 (the TPU; XLA on the CPU), so a pair with a
    subnormal u adds nothing there; PyTorch keeps subnormals, so the flush
    is spelled out (the kernels' ``csrc/pair.cuh:inv_r``)."""
    tiny = torch.finfo(u.dtype).tiny
    return torch.where(u >= tiny, torch.rsqrt(u), 0.0)


# --------------------------------------------------------------------------
# oracle tier: full broadcast, input dtype
# --------------------------------------------------------------------------

def _pair_geometry(pos, eps):
    dr = pos[None, :, :] - pos[:, None, :]
    u = torch.sum(dr * dr, dim=-1) + eps * eps
    return dr, u, _inv_r(u)


def accel_direct(pos, mass, eps=0.0, G=1.0):
    """Oracle acceleration, full (N, N) broadcast in pos.dtype."""
    mass = mass.to(pos.dtype)
    dr, _, inv_r = _pair_geometry(pos, eps)
    w = G * mass[None, :] * inv_r**3
    return torch.sum(w[:, :, None] * dr, dim=1)  # self term: w_ii * 0 = 0


def accel_potential_direct(pos, mass, eps=0.0, G=1.0):
    """Oracle (accel, per-particle potential phi_i), excluding self terms."""
    mass = mass.to(pos.dtype)
    dr, _, inv_r = _pair_geometry(pos, eps)
    w = G * mass[None, :] * inv_r**3
    acc = torch.sum(w[:, :, None] * dr, dim=1)
    phi = -G * torch.sum(mass[None, :] * inv_r, dim=1)
    return acc, phi + self_phi(mass, eps, G)


def accel_jerk_direct(pos, vel, mass, eps=0.0, G=1.0):
    """Oracle (accel, jerk) for the Hermite stepper, full (N, N) broadcast
    in pos.dtype."""
    vel = vel.to(pos.dtype)
    mass = mass.to(pos.dtype)
    dr, u, inv_r = _pair_geometry(pos, eps)
    dv = vel[None, :, :] - vel[:, None, :]
    w = G * mass[None, :] * inv_r**3
    rv = torch.sum(dr * dv, dim=-1)
    tiny = torch.finfo(u.dtype).tiny
    inv_u = torch.where(u > 0, 1.0 / torch.clamp(u, min=tiny), 0.0)
    s = 3.0 * w * rv * inv_u
    acc = torch.sum(w[:, :, None] * dr, dim=1)
    jerk = torch.sum(w[:, :, None] * dv - s[:, :, None] * dr, dim=1)
    return acc, jerk


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


def _block_jerk(src_pos, src_vel, gm, pi, vi, eps2):
    dx = src_pos[None, :, 0] - pi[:, 0:1]
    dy = src_pos[None, :, 1] - pi[:, 1:2]
    dz = src_pos[None, :, 2] - pi[:, 2:3]
    dvx = src_vel[None, :, 0] - vi[:, 0:1]
    dvy = src_vel[None, :, 1] - vi[:, 1:2]
    dvz = src_vel[None, :, 2] - vi[:, 2:3]
    u = dx * dx + dy * dy + dz * dz + eps2
    inv_r = _inv_r(u)
    w = gm * inv_r * inv_r * inv_r
    rv = dx * dvx + dy * dvy + dz * dvz
    # s = 3 w rv / u == 3 rv w inv_r^2 (inv_r is already zero-guarded)
    s = (3.0 * rv) * w * (inv_r * inv_r)
    acc = torch.stack([torch.sum(w * dx, dim=1), torch.sum(w * dy, dim=1),
                       torch.sum(w * dz, dim=1)], dim=1)
    jerk = torch.stack([torch.sum(w * dvx - s * dx, dim=1),
                        torch.sum(w * dvy - s * dy, dim=1),
                        torch.sum(w * dvz - s * dz, dim=1)], dim=1)
    return acc, jerk


def accel_jerk_rows(pos_rows, vel_rows, src_pos, src_vel, src_mass, eps,
                    G=1.0, chunk: int = 1024):
    """(accel, jerk) on rows from sources, all already centred, computed in
    pos_rows.dtype."""
    dtype = pos_rows.dtype
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    gm = (rounded(G, dtype) * src_mass.to(dtype))[None, :]
    blocks = [_block_jerk(src_pos, src_vel, gm, pos_rows[i0:i0 + chunk],
                          vel_rows[i0:i0 + chunk], eps2)
              for i0 in range(0, pos_rows.shape[0], chunk)]
    if not blocks:
        return pos_rows.new_zeros((0, 3)), pos_rows.new_zeros((0, 3))
    return (torch.cat([b[0] for b in blocks]),
            torch.cat([b[1] for b in blocks]))


# --------------------------------------------------------------------------
# cross-pair tier: two DISJOINT sets A and B in one sweep, each pair once,
# returning A's action and B's reaction (the counterpart of the JAX
# package's accel_cross_pair & co.: the chunk pairs of the chunked
# self-interaction, and the halfring sharded step there). The pairwise
# weights are formed once and reduced along both axes. Blocked over A's
# rows, B's sums carried across blocks; inputs are ready for the pair sum
# and centred in ONE frame (per-set centring would put A and B in
# different frames). Disjoint sets have no self pair, so neither potential
# holds a self term.
# --------------------------------------------------------------------------

def _cross_pair(posA, posB, massA, massB, eps, G, chunk, with_phi=False,
                velA=None, velB=None):
    """A's outputs, then B's: (accA, accB), with the potential (accA, phiA,
    accB, phiB), with velocities (accA, jerkA, accB, jerkB); all in
    posA.dtype."""
    dtype = posA.dtype
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    G = rounded(G, dtype)
    gmA = G * massA.to(dtype)
    gmB = (G * massB.to(dtype))[None, :]
    sx, sy, sz = (posB[None, :, k] for k in range(3))
    jerk = velA is not None
    if jerk:
        svx, svy, svz = (velB[None, :, k] for k in range(3))
    nB = posB.shape[0]
    aB = posB.new_zeros((nB, 3))
    bB = posB.new_zeros((nB, 3) if jerk else (nB,))
    aA, bA = [], []
    for i0 in range(0, posA.shape[0], chunk):
        pi = posA[i0:i0 + chunk]
        gi = gmA[i0:i0 + chunk, None]
        dx, dy, dz = sx - pi[:, 0:1], sy - pi[:, 1:2], sz - pi[:, 2:3]
        u = dx * dx + dy * dy + dz * dz + eps2
        inv_r = _inv_r(u)
        inv3 = inv_r * inv_r * inv_r
        w, wi = gmB * inv3, gi * inv3
        aA.append(torch.stack([torch.sum(w * dx, dim=1),
                               torch.sum(w * dy, dim=1),
                               torch.sum(w * dz, dim=1)], dim=1))
        aB = aB - torch.stack([torch.sum(wi * dx, dim=0),
                               torch.sum(wi * dy, dim=0),
                               torch.sum(wi * dz, dim=0)], dim=1)
        if jerk:
            vi = velA[i0:i0 + chunk]
            dvx = svx - vi[:, 0:1]
            dvy = svy - vi[:, 1:2]
            dvz = svz - vi[:, 2:3]
            rv = dx * dvx + dy * dvy + dz * dvz
            s = (3.0 * rv) * (inv_r * inv_r)
            bx, by, bz = dvx - s * dx, dvy - s * dy, dvz - s * dz
            bA.append(torch.stack([torch.sum(w * bx, dim=1),
                                   torch.sum(w * by, dim=1),
                                   torch.sum(w * bz, dim=1)], dim=1))
            bB = bB - torch.stack([torch.sum(wi * bx, dim=0),
                                   torch.sum(wi * by, dim=0),
                                   torch.sum(wi * bz, dim=0)], dim=1)
        elif with_phi:
            bA.append(-torch.sum(gmB * inv_r, dim=1))
            bB = bB - torch.sum(gi * inv_r, dim=0)
    aA = torch.cat(aA) if aA else posA.new_zeros((0, 3))
    if not (jerk or with_phi):
        return aA, aB
    bA = torch.cat(bA) if bA else posA.new_zeros((0, 3) if jerk else (0,))
    return aA, bA, aB, bB


def accel_cross_pair(posA, posB, massA, massB, eps, G=1.0,
                     chunk: int = 1024):
    """(accel on A from B, accel on B from A), each (a, b) pair once."""
    return _cross_pair(posA, posB, massA, massB, eps, G, chunk)


def accel_potential_cross_pair(posA, posB, massA, massB, eps, G=1.0,
                               chunk: int = 1024):
    """(accA, phiA, accB, phiB); the sets are disjoint, so neither phi has
    a self term (no ``self_phi`` correction applies)."""
    return _cross_pair(posA, posB, massA, massB, eps, G, chunk,
                       with_phi=True)


def accel_jerk_cross_pair(posA, velA, posB, velB, massA, massB, eps, G=1.0,
                          chunk: int = 1024):
    """(accA, jerkA, accB, jerkB); the bracket dv - 3 (r.v) inv^2 d serves
    both directions (the reaction jerk is minus the action pairwise)."""
    return _cross_pair(posA, posB, massA, massB, eps, G, chunk, velA=velA,
                       velB=velB)


# --------------------------------------------------------------------------
# single-device wrappers: centre -> cast -> rows == sources -> cast back
# --------------------------------------------------------------------------

def prepare_f32(pos, mass, vel=None, compute_dtype=torch.float32):
    """Centre on the mean position (and velocity) and cast for the pair
    sum. Pairwise differences are shift-invariant, so centring costs nothing
    physically but keeps the f32 mantissa for a cluster far from the origin
    (the north star sits 8 kpc out) or moving fast along its orbit (~220
    km/s at 8 kpc, where an uncentred f32 dv would lose its mantissa).
    Returns (pos_c, mass_c), or (pos_c, mass_c, vel_c) when ``vel`` is
    given."""
    pos_c = (pos - torch.mean(pos, dim=0)).to(compute_dtype).contiguous()
    mass_c = mass.to(compute_dtype).contiguous()
    if vel is None:
        return pos_c, mass_c
    vel_c = (vel - torch.mean(vel, dim=0)).to(compute_dtype).contiguous()
    return pos_c, mass_c, vel_c


def split_hilo(c):
    """A centred f64 tensor as its (hi, lo) pair of f32: hi the rounded
    value, lo the rounded remainder, so hi + lo holds c to ~2^-48 of it
    (the JAX package's ``_split_rows`` after its subtraction)."""
    hi = c.to(torch.float32)
    lo = (c - hi.to(c.dtype)).to(torch.float32)
    return hi.contiguous(), lo.contiguous()


def centre_split(x):
    """(hi, lo, centre): ``x`` centred on its unweighted mean in f64, then
    split."""
    x = x.to(torch.float64)
    centre = torch.mean(x, dim=0)
    return (*split_hilo(x - centre), centre)


def gm_f32(mass, G):
    """G·m formed in f64 and rounded to f32 once (the f32 tier multiplies
    G32·m32 instead)."""
    return (G * mass.to(torch.float64)).to(torch.float32).contiguous()


def prepare_x(pos, mass, G, vel=None):
    """Operands of the extended (hi/lo) tier, the counterpart of the JAX
    package's ``_prep_x_T`` without its padding and transposition: ONE
    centring on the unweighted mean position (and velocity), in f64, then
    the hi/lo split, and ``gm_f32``. Returns (hi, lo, gm), or (hi, lo, gm,
    vhi, vlo) when ``vel`` is given."""
    hi, lo, _ = centre_split(pos)
    gm = gm_f32(mass, G)
    if vel is None:
        return hi, lo, gm
    vhi, vlo, _ = centre_split(vel)
    return hi, lo, gm, vhi, vlo


def accel(pos, mass, eps=0.0, G=1.0, *, compute_dtype=torch.float32,
          chunk=1024):
    """Blocked pairwise acceleration; returns (N, 3) in pos.dtype."""
    pos_c, mass_c = prepare_f32(pos, mass, compute_dtype=compute_dtype)
    return accel_rows(pos_c, pos_c, mass_c, eps, G, chunk).to(pos.dtype)


def accel_potential(pos, mass, eps=0.0, G=1.0, *,
                    compute_dtype=torch.float32, chunk=1024):
    """Blocked (accel, phi); self term removed."""
    pos_c, mass_c = prepare_f32(pos, mass, compute_dtype=compute_dtype)
    acc, phi = accel_potential_rows(pos_c, pos_c, mass_c, eps, G, chunk)
    phi = phi + self_phi(mass_c, eps, G)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def potential(pos, mass, eps=0.0, G=1.0, *, compute_dtype=torch.float64,
              chunk=512):
    """The per-particle pair potential alone, self term removed: what
    ``accel_potential`` returns as phi, without the acceleration sums. In
    f64 it is the plain twin of K23, the f64 diagnostics potential
    (``output.diag_f64``, ``ops/cuda_phi64.py``); the (chunk, N)
    temporaries bound its memory."""
    pos_c, mass_c = prepare_f32(pos, mass, compute_dtype=compute_dtype)
    eps2 = rounded(rounded(eps, compute_dtype) ** 2, compute_dtype)
    gm = (rounded(G, compute_dtype) * mass_c)[None, :]
    x, y, z = (pos_c[None, :, k] for k in range(3))
    blocks = []
    for i0 in range(0, pos_c.shape[0], chunk):
        pi = pos_c[i0:i0 + chunk]
        dx, dy, dz = x - pi[:, 0:1], y - pi[:, 1:2], z - pi[:, 2:3]
        u = dx * dx + dy * dy + dz * dz + eps2
        blocks.append(-torch.sum(gm * _inv_r(u), dim=1))
    phi = torch.cat(blocks) if blocks else pos_c.new_zeros((0,))
    return (phi + self_phi(mass_c, eps, G)).to(pos.dtype)


def accel_jerk(pos, vel, mass, eps=0.0, G=1.0, *,
               compute_dtype=torch.float32, chunk=1024):
    """Blocked (accel, jerk) for the Hermite-4 stepper; pos.dtype out."""
    pos_c, mass_c, vel_c = prepare_f32(pos, mass, vel=vel,
                                       compute_dtype=compute_dtype)
    acc, jerk = accel_jerk_rows(pos_c, vel_c, pos_c, vel_c, mass_c, eps, G,
                                chunk)
    return acc.to(pos.dtype), jerk.to(pos.dtype)
