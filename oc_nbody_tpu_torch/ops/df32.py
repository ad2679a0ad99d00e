"""The extended (hi/lo) and the two-float (df32) precision tiers in plain
PyTorch: the reference the tiers' CUDA kernels are held to, and what their
wrappers run on CPU tensors (counterpart of ``oc_nbody_tpu/ops/df32.py``).

Extended tier. Positions (and velocities, for the jerk) enter as (hi, lo)
f32 splits of the centred f64 state. Per pair, with d = hi_j - hi_i and
e = lo_j - lo_i:
  u   = d·d + (2 d·e + eps²)        the e² term is below f32 resolution
  inv = rsqrt(u), refined by one Newton step inv·(1.5 − 0.5 u inv²)
  s   = d + e                       the lo-corrected separation
and the sums of ``ops/gravity.py`` run on s, inv and dv = (vhi_j − vhi_i) +
(vlo_j − vlo_i). The potential is RAW: it keeps the softened self term
−G m_i/eps of a row that is also a source; the caller adds
``gravity.self_phi``.

Two-float tier. A df number is a pair (hi, lo) of f32 with |lo| <=
ulp(hi)/2, about 48 significand bits. ``two_sum`` (Knuth), ``quick_two_sum``
and ``two_prod`` (Dekker, on a 12-bit mask split) are error-free: s + e ==
a + b and p + e == a·b exactly. ``df_add`` / ``df_mul`` / ``df_sqr`` /
``df_mul_f`` / ``df_rsqrt`` build on them, and ``_df_row_block`` evaluates
every pair quantity (separation, r², rsqrt, weight, the products summed) as
a df number; the sum over sources is taken in f64 over both words. gm = G·m
and eps² are formed in f64 and split as well. The JAX module pins its
rounded sums with optimisation barriers and splits through an integer
bitcast because XLA's simplifier rewrites the classic forms inside fused
graphs; eager PyTorch rounds every operation as written and fuses nothing,
so the barriers have no counterpart here, and the mask split is kept only
because eager PyTorch has no fused multiply-add to build ``two_prod`` from.

Families, as in the JAX package:
  * ``*_rows_x_hilo`` and ``*_rows_df_hilo`` — pre-split planes in, sums
    out: f32 is the tier itself (the kernels' arithmetic per pair);
    ``dtype=torch.float64`` evaluates the same planes in f64, the oracle
    the kernels are compared with on the card. The extended forms return
    ``dtype``; the df forms return f64 (the two words summed).
  * ``*_cross_pair_x_hilo`` — the extended tier on two disjoint sets in
    one sweep, each pair once: A's action and B's reaction, in ``dtype``.
  * ``accel_extended`` / ``accel_df`` and their potential and jerk forms —
    f64 state in and out; centre once, split, rows == sources.
"""
from __future__ import annotations

import torch

from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.ops.gravity import _inv_r, rounded


def _ext_sep_inv(rhi, rlo, shi, slo, eps2, guarded):
    """(s, inv) of a (B, 3) row block against (N, 3) sources: the
    lo-corrected separations s (three (B, N) planes) and the Newton-refined
    inverse distance."""
    d = [shi[None, :, k] - rhi[:, k:k + 1] for k in range(3)]
    e = [slo[None, :, k] - rlo[:, k:k + 1] for k in range(3)]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    de = d[0] * e[0] + d[1] * e[1] + d[2] * e[2]
    u = dd + (2.0 * de + eps2)
    inv = _inv_r(u) if guarded else torch.rsqrt(u)
    inv = inv * (1.5 - (0.5 * u) * (inv * inv))
    return [d[k] + e[k] for k in range(3)], inv


def _ext_dv(vhi, vlo, svhi, svlo):
    """The relative velocities (vhi_j - vhi_i) + (vlo_j - vlo_i)."""
    return [(svhi[None, :, k] - vhi[:, k:k + 1])
            + (svlo[None, :, k] - vlo[:, k:k + 1]) for k in range(3)]


def _ext_row_block(rhi, rlo, shi, slo, gm, eps2, guarded, want_phi=False,
                   vhi=None, vlo=None, svhi=None, svlo=None):
    """(accel[, phi][, jerk]) of a (B, 3) row block from all sources at the
    extended tier, in the planes' dtype. rows (B, 3); sources (N, 3); gm
    (N,)."""
    s, inv = _ext_sep_inv(rhi, rlo, shi, slo, eps2, guarded)
    inv2 = inv * inv
    gminv = gm[None, :] * inv
    w = gminv * inv2
    out = [torch.stack([torch.sum(w * s[k], dim=1) for k in range(3)], dim=1)]
    if want_phi:
        out.append(-torch.sum(gminv, dim=1))
    if svhi is not None:
        dv = _ext_dv(vhi, vlo, svhi, svlo)
        rv = s[0] * dv[0] + s[1] * dv[1] + s[2] * dv[2]
        sc = (3.0 * rv) * w * inv2
        out.append(torch.stack(
            [torch.sum(w * dv[k] - sc * s[k], dim=1) for k in range(3)],
            dim=1))
    return tuple(out)


def _rows_x(rows, vrows, src, svel, gm, eps, chunk, guarded, dtype,
            want_phi):
    """The chunked row sweep of the three ``*_rows_x_hilo`` functions.
    ``rows`` = (rhi, rlo), ``src`` = (shi, slo); ``vrows`` / ``svel`` the
    velocity planes or None."""
    cast = lambda ts: None if ts is None else tuple(t.to(dtype) for t in ts)
    rows, vrows, src, svel = cast(rows), cast(vrows), cast(src), cast(svel)
    gm = gm.to(dtype)
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    nr = rows[0].shape[0]
    blocks = []
    for i0 in range(0, nr, chunk):
        sl = slice(i0, i0 + chunk)
        vel = {} if vrows is None else dict(
            vhi=vrows[0][sl], vlo=vrows[1][sl], svhi=svel[0], svlo=svel[1])
        blocks.append(_ext_row_block(rows[0][sl], rows[1][sl], src[0],
                                     src[1], gm, eps2, guarded, want_phi,
                                     **vel))
    n_out = 1 + int(want_phi) + int(vrows is not None)
    if not blocks:
        shapes = [(0, 3)] + ([(0,)] if want_phi else []) \
            + ([(0, 3)] if vrows is not None else [])
        return tuple(rows[0].new_zeros(s) for s in shapes)
    return tuple(torch.cat([b[k] for b in blocks]) for k in range(n_out))


def accel_rows_x_hilo(rhi, rlo, shi, slo, gm, eps, chunk: int = 256,
                      guarded: bool = True, dtype=torch.float32):
    """Extended-tier accel of rows from sources on pre-split planes."""
    return _rows_x((rhi, rlo), None, (shi, slo), None, gm, eps, chunk,
                   guarded, dtype, False)[0]


def accel_potential_rows_x_hilo(rhi, rlo, shi, slo, gm, eps,
                                chunk: int = 256, guarded: bool = True,
                                dtype=torch.float32):
    """Extended-tier (accel, phi) of rows from sources. With eps > 0 phi
    INCLUDES the softened self term of a row that is also a source (the
    caller adds ``gravity.self_phi``)."""
    return _rows_x((rhi, rlo), None, (shi, slo), None, gm, eps, chunk,
                   guarded, dtype, True)


def accel_jerk_rows_x_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm, eps,
                           chunk: int = 256, guarded: bool = True,
                           dtype=torch.float32):
    """Extended-tier (accel, jerk) of rows from sources on pre-split
    position and velocity planes."""
    return _rows_x((rhi, rlo), (vhi, vlo), (shi, slo), (svhi, svlo), gm, eps,
                   chunk, guarded, dtype, False)


# --------------------------------------------------------------------------
# extended-tier cross pairs: two DISJOINT sets A and B in one sweep, each
# pair once, A's action and B's reaction (the chunk pairs of the chunked
# extended self-interaction). Pre-split planes under ONE centring, as above.
# --------------------------------------------------------------------------

def _ext_cross_block(rhi, rlo, gmA, shi, slo, gmB, eps2, guarded,
                     want_phi=False, vhi=None, vlo=None, svhi=None,
                     svlo=None):
    """((A's outputs), (B's reaction contributions)) of a (B, 3) block of
    A's rows against all of B at the extended tier, in the planes' dtype;
    each tuple (accel[, phi][, jerk])."""
    s, inv = _ext_sep_inv(rhi, rlo, shi, slo, eps2, guarded)
    inv2 = inv * inv
    gminv_b = gmB[None, :] * inv
    gminv_a = gmA[:, None] * inv
    w_b, w_a = gminv_b * inv2, gminv_a * inv2

    def both(fb, fa):
        return (torch.stack([torch.sum(fb(k), dim=1) for k in range(3)],
                            dim=1),
                -torch.stack([torch.sum(fa(k), dim=0) for k in range(3)],
                             dim=1))

    acc_a, acc_b = both(lambda k: w_b * s[k], lambda k: w_a * s[k])
    out_a, out_b = [acc_a], [acc_b]
    if want_phi:
        out_a.append(-torch.sum(gminv_b, dim=1))
        out_b.append(-torch.sum(gminv_a, dim=0))
    if svhi is not None:
        dv = _ext_dv(vhi, vlo, svhi, svlo)
        rv = s[0] * dv[0] + s[1] * dv[1] + s[2] * dv[2]
        sc_b = (3.0 * rv) * w_b * inv2
        sc_a = (3.0 * rv) * w_a * inv2
        jerk_a, jerk_b = both(lambda k: w_b * dv[k] - sc_b * s[k],
                              lambda k: w_a * dv[k] - sc_a * s[k])
        out_a.append(jerk_a)
        out_b.append(jerk_b)
    return tuple(out_a), tuple(out_b)


def _cross_x(a, b, vel_a, vel_b, gmA, gmB, eps, chunk, guarded, dtype,
             want_phi):
    """The sweep of the three ``*_cross_pair_x_hilo`` functions over A's
    row blocks, B's reactions added block by block. ``a`` = (hi, lo) of A,
    ``b`` of B; ``vel_a`` / ``vel_b`` the velocity planes or None. Returns
    A's outputs, then B's."""
    cast = lambda ts: None if ts is None else tuple(t.to(dtype) for t in ts)
    a, b, vel_a, vel_b = cast(a), cast(b), cast(vel_a), cast(vel_b)
    gmA, gmB = gmA.to(dtype), gmB.to(dtype)
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    n_a, n_b = a[0].shape[0], b[0].shape[0]
    shapes = [(3,)] + ([()] if want_phi else []) \
        + ([(3,)] if vel_a is not None else [])
    outs_b = [a[0].new_zeros((n_b,) + s) for s in shapes]
    blocks = []
    for i0 in range(0, n_a, chunk):
        sl = slice(i0, i0 + chunk)
        vel = {} if vel_a is None else dict(
            vhi=vel_a[0][sl], vlo=vel_a[1][sl], svhi=vel_b[0], svlo=vel_b[1])
        out_a, out_b = _ext_cross_block(a[0][sl], a[1][sl], gmA[sl], b[0],
                                        b[1], gmB, eps2, guarded, want_phi,
                                        **vel)
        blocks.append(out_a)
        outs_b = [o + p for o, p in zip(outs_b, out_b)]
    outs_a = [torch.cat([blk[k] for blk in blocks]) if blocks
              else a[0].new_zeros((0,) + s) for k, s in enumerate(shapes)]
    return (*outs_a, *outs_b)


def accel_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB, eps,
                            chunk: int = 256, guarded: bool = True,
                            dtype=torch.float32):
    """Extended-tier (accel on A from B, accel on B from A) of two disjoint
    sets on pre-split planes, each pair once."""
    return _cross_x((rAhi, rAlo), (rBhi, rBlo), None, None, gmA, gmB, eps,
                    chunk, guarded, dtype, False)


def accel_potential_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB, eps,
                                      chunk: int = 256,
                                      guarded: bool = True,
                                      dtype=torch.float32):
    """Extended-tier (accA, phiA, accB, phiB); the sets are disjoint, so
    neither phi holds a self term."""
    return _cross_x((rAhi, rAlo), (rBhi, rBlo), None, None, gmA, gmB, eps,
                    chunk, guarded, dtype, True)


def accel_jerk_cross_pair_x_hilo(rAhi, rAlo, vAhi, vAlo, rBhi, rBlo, vBhi,
                                 vBlo, gmA, gmB, eps, chunk: int = 256,
                                 guarded: bool = True, dtype=torch.float32):
    """Extended-tier (accA, jerkA, accB, jerkB) on pre-split position and
    velocity planes."""
    return _cross_x((rAhi, rAlo), (rBhi, rBlo), (vAhi, vAlo), (vBhi, vBlo),
                    gmA, gmB, eps, chunk, guarded, dtype, False)


def accel_extended(pos, mass, eps=0.0, G=1.0, chunk: int = 1024,
                   guarded: bool = True):
    """Extended-precision pairwise accel; f64 in and out (one centring and
    the hi/lo split inside)."""
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    return accel_rows_x_hilo(hi, lo, hi, lo, gm, eps, chunk,
                             guarded).to(pos.dtype)


def accel_potential_extended(pos, mass, eps=0.0, G=1.0, chunk: int = 1024,
                             guarded: bool = True):
    """(accel, raw phi) at the extended tier; f64 in and out."""
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    acc, phi = accel_potential_rows_x_hilo(hi, lo, hi, lo, gm, eps, chunk,
                                           guarded)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_extended(pos, vel, mass, eps=0.0, G=1.0, chunk: int = 1024,
                        guarded: bool = True):
    """(accel, jerk) at the extended tier (the Hermite force evaluation);
    f64 in and out."""
    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos, mass, G, vel=vel)
    acc, jerk = accel_jerk_rows_x_hilo(hi, lo, vhi, vlo, hi, lo, vhi, vlo,
                                       gm, eps, chunk, guarded)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


# --------------------------------------------------------------------------
# error-free transformations and df arithmetic on f32 tensors
# --------------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """a == hi + lo with hi carrying the top 12 significand bits (the low
    12 mantissa bits masked off), so hi·hi, hi·lo and lo·lo are exact in
    f32."""
    hi = (a.contiguous().view(torch.int32) & -4096).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, no FMA)."""
    a, b = torch.broadcast_tensors(a, b)
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_f64(a):
    """An f64 tensor as its f32 (hi, lo) pair (``gravity.split_hilo``)."""
    return gravity.split_hilo(a)


def df_to_f64(x):
    return x[0].to(torch.float64) + x[1].to(torch.float64)


def df_neg(x):
    return -x[0], -x[1]


def df_add(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_sqr(x):
    p, e = two_prod(x[0], x[0])
    e = e + 2.0 * (x[0] * x[1])
    return quick_two_sum(p, e)


def df_mul_f(x, b):
    """A df number times an f32 tensor or float ``b``."""
    b = torch.as_tensor(b, dtype=torch.float32, device=x[0].device)
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return quick_two_sum(p, e)


def df_rsqrt(x):
    """df 1/sqrt(x): f32 rsqrt seed, one plain-f32 Newton step, one df
    Newton step (y <- y (3 - x y²)/2; the error squares each step). The f32
    step brings a seed of 2 ulp (the card's rsqrtf) to f32 accuracy, so the
    df step lands near 1e-14 whatever the seed's source."""
    y0 = torch.rsqrt(x[0])
    y0 = y0 * (1.5 - (0.5 * x[0]) * (y0 * y0))
    y = (y0, torch.zeros_like(y0))
    xy2 = df_mul(x, df_sqr(y))
    three = torch.full_like(y0, 3.0)
    three_minus = df_add((three, torch.zeros_like(y0)), df_neg(xy2))
    return df_mul_f(df_mul(y, three_minus), 0.5)


# --------------------------------------------------------------------------
# the two-float tier: every pair quantity a df number
# --------------------------------------------------------------------------

def _df_reduce(x):
    """The f64 sum of a df pair over the source axis: O(N) per row beside
    the O(N²) pair work."""
    return (torch.sum(x[0].to(torch.float64), dim=-1)
            + torch.sum(x[1].to(torch.float64), dim=-1))


def _df_sep(shi, slo, rhi, rlo, k):
    """Component k of the df separation source − row: the exact difference
    of the hi words by ``two_sum``, the lo difference folded in, then
    RENORMALISED by a second ``two_sum``. For a close pair the lo
    correction exceeds ulp(d), and ``df_sqr`` on an unnormalised pair drops
    (de/d)² of the result."""
    d, de = two_sum(shi[None, :, k], -rhi[:, k:k + 1])
    de = de + (slo[None, :, k] - rlo[:, k:k + 1])
    return two_sum(d, de)


def _df_row_block(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi, eps2_lo,
                  guarded, want_phi=False, vhi=None, vlo=None, svhi=None,
                  svlo=None):
    """(accel[, phi][, jerk]) of a (B, 3) row block from all sources, every
    pair quantity df; f64 out. rows (B, 3); sources (N, 3); gm (N,); eps²
    a df pair of host floats."""
    d = [_df_sep(shi, slo, rhi, rlo, k) for k in range(3)]
    zero = torch.zeros_like(d[0][0])
    u = (zero, zero)
    for k in range(3):
        u = df_add(u, df_sqr(d[k]))
    u = df_add(u, (zero + eps2_hi, zero + eps2_lo))
    inv = df_rsqrt(u)
    if guarded:  # gravity._inv_r's guard on the hi word (csrc/df.cuh)
        ok = u[0] >= torch.finfo(u[0].dtype).tiny
        inv = (torch.where(ok, inv[0], 0.0), torch.where(ok, inv[1], 0.0))
    gminv = df_mul((gm_hi[None, :], gm_lo[None, :]), inv)
    inv2 = df_sqr(inv)
    w = df_mul(gminv, inv2)                               # gm inv³
    out = [torch.stack([_df_reduce(df_mul(w, d[k])) for k in range(3)],
                       dim=1)]
    if want_phi:
        out.append(-_df_reduce(gminv))
    if svhi is not None:
        dv = [_df_sep(svhi, svlo, vhi, vlo, k) for k in range(3)]
        rv = (zero, zero)
        for k in range(3):
            rv = df_add(rv, df_mul(d[k], dv[k]))
        s = df_mul(df_mul_f(rv, 3.0), df_mul(w, inv2))    # 3 rv w inv²
        out.append(torch.stack(
            [_df_reduce(df_add(df_mul(w, dv[k]), df_mul(df_neg(s), d[k])))
             for k in range(3)], dim=1))
    return tuple(out)


def _f64_row_block(rows, src, gm, eps2, want_phi, vrows=None, svel=None):
    """The same sums on the recombined f64 values (hi + lo), in plain f64:
    the oracle of the df forms."""
    if svel is not None:
        return gravity._block_jerk(src, svel, gm[None, :], rows, vrows, eps2)
    acc, phi = gravity._block(src, gm[None, :], rows, eps2, want_phi)
    return (acc, phi) if want_phi else (acc,)


# elements of one (chunk, N) temporary the df sweep may hold: it keeps some
# forty of them alive, so 2^25 f32 elements bound the sweep near 5 GB
_DF_CHUNK_ELEMS = 1 << 25


def _rows_df(rows, vrows, src, svel, gm, eps2, chunk, guarded, dtype,
             want_phi):
    """The chunked row sweep of the three ``*_rows_df_hilo`` functions.
    ``rows`` = (rhi, rlo), ``src`` = (shi, slo), ``gm`` = (gm_hi, gm_lo),
    ``eps2`` = (hi, lo) host floats; ``vrows`` / ``svel`` the velocity
    planes or None. The row chunk shrinks with the source count."""
    nr, ns = rows[0].shape[0], src[0].shape[0]
    chunk = max(1, min(chunk, _DF_CHUNK_ELEMS // max(ns, 1)))
    f64 = torch.float64
    if dtype == f64:
        rows, vrows, src, svel, gm = (
            None if t is None else t[0].to(f64) + t[1].to(f64)
            for t in (rows, vrows, src, svel, gm))
        eps2 = float(eps2[0]) + float(eps2[1])
    elif dtype != torch.float32:
        raise TypeError(f"the df forms evaluate in float32 (the tier) or "
                        f"float64 (its oracle), not {dtype}")
    blocks = []
    for i0 in range(0, nr, chunk):
        sl = slice(i0, i0 + chunk)
        if dtype == f64:
            blocks.append(_f64_row_block(
                rows[sl], src, gm, eps2, want_phi,
                None if vrows is None else vrows[sl], svel))
        else:
            vel = {} if vrows is None else dict(
                vhi=vrows[0][sl], vlo=vrows[1][sl], svhi=svel[0],
                svlo=svel[1])
            blocks.append(_df_row_block(rows[0][sl], rows[1][sl], *src, *gm,
                                        *eps2, guarded, want_phi, **vel))
    n_out = 1 + int(want_phi) + int(vrows is not None)
    if not blocks:
        shapes = [(0, 3)] + ([(0,)] if want_phi else []) \
            + ([(0, 3)] if vrows is not None else [])
        return tuple(torch.zeros(s, dtype=f64, device=src[0].device)
                     for s in shapes)
    return tuple(torch.cat([b[k] for b in blocks]) for k in range(n_out))


def accel_rows_df_hilo(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi, eps2_lo,
                       chunk: int = 256, guarded: bool = True,
                       dtype=torch.float32):
    """Two-float accel of rows from sources on pre-split planes; f64 out."""
    return _rows_df((rhi, rlo), None, (shi, slo), None, (gm_hi, gm_lo),
                    (eps2_hi, eps2_lo), chunk, guarded, dtype, False)[0]


def accel_potential_rows_df_hilo(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi,
                                 eps2_lo, chunk: int = 256,
                                 guarded: bool = True, dtype=torch.float32):
    """Two-float (accel, RAW phi) of rows from sources; f64 out. With
    eps > 0 phi INCLUDES the softened self term of a row that is also a
    source (the caller adds ``gravity.self_phi``)."""
    return _rows_df((rhi, rlo), None, (shi, slo), None, (gm_hi, gm_lo),
                    (eps2_hi, eps2_lo), chunk, guarded, dtype, True)


def accel_jerk_rows_df_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm_hi,
                            gm_lo, eps2_hi, eps2_lo, chunk: int = 256,
                            guarded: bool = True, dtype=torch.float32):
    """Two-float (accel, jerk) of rows from sources on pre-split position
    and velocity planes; f64 out."""
    return _rows_df((rhi, rlo), (vhi, vlo), (shi, slo), (svhi, svlo),
                    (gm_hi, gm_lo), (eps2_hi, eps2_lo), chunk, guarded,
                    dtype, False)


def split_scalar(x: float):
    """A host f64 scalar as its (hi, lo) pair of f32-valued floats."""
    hi = rounded(x, torch.float32)
    return hi, rounded(x - hi, torch.float32)


def _df_prepare(pos, mass, eps, G, vel=None):
    """Operands of the two-float tier: positions (and velocities) centred
    on their unweighted mean in f64 and split; gm = G·m formed in f64 and
    split; eps² formed in f64 and split (a single-f32 eps² caps the force
    accuracy of softening-dominated close pairs near 1e-7). Returns (hi,
    lo, gm_hi, gm_lo, eps2_hi, eps2_lo), then (vhi, vlo) when ``vel`` is
    given."""
    hi, lo, _ = gravity.centre_split(pos)
    gm_hi, gm_lo = gravity.split_hilo(G * mass.to(torch.float64))
    out = (hi, lo, gm_hi, gm_lo, *split_scalar(float(eps) ** 2))
    if vel is None:
        return out
    vhi, vlo, _ = gravity.centre_split(vel)
    return (*out, vhi, vlo)


def accel_df(pos, mass, eps=0.0, G=1.0, chunk: int = 256,
             guarded: bool = True):
    """Two-float pairwise accel; f64 in, pos.dtype out. Per-pair error
    near 1e-10 relative against the f64 oracle, close pairs included."""
    hi, lo, *rest = _df_prepare(pos, mass, eps, G)
    return accel_rows_df_hilo(hi, lo, hi, lo, *rest, chunk,
                              guarded).to(pos.dtype)


def accel_potential_df(pos, mass, eps=0.0, G=1.0, chunk: int = 256,
                       guarded: bool = True):
    """(accel, RAW phi) at the two-float tier; the caller adds
    ``gravity.self_phi``."""
    hi, lo, *rest = _df_prepare(pos, mass, eps, G)
    acc, phi = accel_potential_rows_df_hilo(hi, lo, hi, lo, *rest, chunk,
                                            guarded)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_df(pos, vel, mass, eps=0.0, G=1.0, chunk: int = 256,
                  guarded: bool = True):
    """(accel, jerk) at the two-float tier (the Hermite force
    evaluation)."""
    hi, lo, gm_hi, gm_lo, e2h, e2l, vhi, vlo = _df_prepare(pos, mass, eps, G,
                                                           vel=vel)
    acc, jerk = accel_jerk_rows_df_hilo(hi, lo, vhi, vlo, hi, lo, vhi, vlo,
                                        gm_hi, gm_lo, e2h, e2l, chunk,
                                        guarded)
    return acc.to(pos.dtype), jerk.to(pos.dtype)
