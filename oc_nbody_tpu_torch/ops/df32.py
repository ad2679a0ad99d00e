"""The extended (hi/lo) precision tier in plain PyTorch: the reference the
extended CUDA kernels are held to, and what their wrappers run on CPU
tensors (counterpart of the extended half of ``oc_nbody_tpu/ops/df32.py``).

Positions (and velocities, for the jerk) enter as (hi, lo) f32 splits of the
centred f64 state. Per pair, with d = hi_j - hi_i and e = lo_j - lo_i:
  u   = d·d + (2 d·e + eps²)        the e² term is below f32 resolution
  inv = rsqrt(u), refined by one Newton step inv·(1.5 − 0.5 u inv²)
  s   = d + e                       the lo-corrected separation
and the sums of ``ops/gravity.py`` run on s, inv and dv = (vhi_j − vhi_i) +
(vlo_j − vlo_i). The potential is RAW: it keeps the softened self term
−G m_i/eps of a row that is also a source; the caller adds
``gravity.self_phi``.

Two families, as in the JAX package:
  * ``*_rows_x_hilo`` — pre-split planes in, sums out, all in one dtype:
    f32 is the tier itself (the kernels' order of operations per pair);
    ``dtype=torch.float64`` evaluates the same planes in f64, the oracle
    the kernels are compared with on the card.
  * ``accel_extended`` / ``accel_potential_extended`` /
    ``accel_jerk_extended`` — f64 state in and out; centre once, split,
    rows == sources.

The two-float (``df_*``) half of the JAX module — error-free transforms and
the full df32 pair sum — is not ported here; it belongs to the df32 tier
(ROADMAP B8).
"""
from __future__ import annotations

import torch

from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.ops.gravity import _inv_r, rounded


def _ext_row_block(rhi, rlo, shi, slo, gm, eps2, guarded, want_phi=False,
                   vhi=None, vlo=None, svhi=None, svlo=None):
    """(accel[, phi][, jerk]) of a (B, 3) row block from all sources at the
    extended tier, in the planes' dtype. rows (B, 3); sources (N, 3); gm
    (N,)."""
    d = [shi[None, :, k] - rhi[:, k:k + 1] for k in range(3)]
    e = [slo[None, :, k] - rlo[:, k:k + 1] for k in range(3)]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    de = d[0] * e[0] + d[1] * e[1] + d[2] * e[2]
    u = dd + (2.0 * de + eps2)
    inv = _inv_r(u) if guarded else torch.rsqrt(u)
    inv = inv * (1.5 - (0.5 * u) * (inv * inv))
    s = [d[k] + e[k] for k in range(3)]
    inv2 = inv * inv
    gminv = gm[None, :] * inv
    w = gminv * inv2
    out = [torch.stack([torch.sum(w * s[k], dim=1) for k in range(3)], dim=1)]
    if want_phi:
        out.append(-torch.sum(gminv, dim=1))
    if svhi is not None:
        dv = [(svhi[None, :, k] - vhi[:, k:k + 1])
              + (svlo[None, :, k] - vlo[:, k:k + 1]) for k in range(3)]
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
