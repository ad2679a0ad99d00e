"""The two-float (df32) pairwise tier on the card: two hand-written CUDA
kernels, each beside its plain PyTorch twin (counterpart of
``oc_nbody_tpu/ops/pallas_df.py``).

  * K10 ``csrc/rows_accel_df.cu`` — self-interaction accel with every pair
    quantity and the sum over sources a (hi, lo) pair of f32. Replaces
    ``_accel_kernel_df`` (oc_nbody_tpu/ops/pallas_df.py:121).
  * K11 ``csrc/rows_jerk_df.cu`` — the same with the jerk, the Hermite
    force evaluation of the tier. Replaces ``_accel_jerk_kernel_df``
    (oc_nbody_tpu/ops/pallas_df.py:186).

Both share their arithmetic (``csrc/df.cuh``) and are built into the one
library of ``ops/cuda_gravity.py``, whose build and launch helpers this
module uses. ``rows_df_kernel`` / ``rows_jerk_df_kernel`` launch on (hi, lo)
f32 CUDA planes and return f64 (the two output words summed);
``rows_df_plain`` / ``rows_jerk_df_plain`` are the same functions in plain
PyTorch (``ops/df32.py``): in f32 the tier itself, with
``dtype=torch.float64`` the same planes evaluated in f64, the oracle the
kernels are held to on the card. The public ``accel_df`` and
``accel_jerk_df`` take the f64 state, centre and split it, launch the kernel
for CUDA tensors and call the twin for CPU tensors; there is no fallback
from one to the other. ``cuda_gravity.LAUNCHES`` / ``PLAIN_CALLS`` count
both under ``rows_df`` and ``rows_jerk_df``.

The kernels hold their sources resident, as the TPU kernels do: past
``STREAM_N`` particles the public forms raise NotImplementedError.

``eft_selftest_kernel`` applies the device's ``two_sum``, ``two_prod`` and
``df_rsqrt`` elementwise, so a test can hold them to exactness;
``eft_selftest_plain`` is the twins' counterpart.
"""
from __future__ import annotations

import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import df32

_F64 = torch.float64


def _check_operands(nr, ns, rows, src, gm_hi, gm_lo):
    for name, t in rows.items():
        cg._check_f32(name, t, (nr, 3))
    for name, t in src.items():
        cg._check_f32(name, t, (ns, 3))
    cg._check_f32("gm_hi", gm_hi, (ns,))
    cg._check_f32("gm_lo", gm_lo, (ns,))


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------

def rows_df_plain(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi, eps2_lo,
                  dtype=torch.float32, chunk=256, guarded=True):
    """K10's function in plain PyTorch on the same planes: in f32 the
    two-float tier, in f64 the oracle. f64 (nr, 3) out."""
    cg.PLAIN_CALLS["rows_df"] += 1
    return df32.accel_rows_df_hilo(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi,
                                   eps2_lo, chunk, guarded, dtype)


def rows_jerk_df_plain(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm_hi, gm_lo,
                       eps2_hi, eps2_lo, dtype=torch.float32, chunk=256,
                       guarded=True):
    """K11's function in plain PyTorch; f64 (acc, jerk) out."""
    cg.PLAIN_CALLS["rows_jerk_df"] += 1
    return df32.accel_jerk_rows_df_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi,
                                        svlo, gm_hi, gm_lo, eps2_hi, eps2_lo,
                                        chunk, guarded, dtype)


def eft_selftest_plain(a, b, xh, xl):
    """(s, se, p, pe, yh, yl) of the twins' ``two_sum(a, b)``,
    ``two_prod(a, b)`` and ``df_rsqrt((xh, xl))``."""
    return (*df32.two_sum(a, b), *df32.two_prod(a, b),
            *df32.df_rsqrt((xh, xl)))


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

def rows_df_kernel(rhi, rlo, shi, slo, gm_hi, gm_lo, eps2_hi, eps2_lo,
                   guarded=True):
    """Launch K10 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``rows_df_plain``."""
    nr, ns = rhi.shape[0], shi.shape[0]
    _check_operands(nr, ns, dict(rows_hi=rhi, rows_lo=rlo),
                    dict(src_hi=shi, src_lo=slo), gm_hi, gm_lo)
    lib = cg._library()
    f32 = torch.float32
    scratch = torch.empty((lib.ocn_rows_accel_df_scratch(nr, ns),), dtype=f32,
                          device=rhi.device)
    out = torch.empty((2, nr, 3), dtype=f32, device=rhi.device)
    code = lib.ocn_rows_accel_df(
        rhi.data_ptr(), rlo.data_ptr(), nr, shi.data_ptr(), slo.data_ptr(),
        gm_hi.data_ptr(), gm_lo.data_ptr(), ns, eps2_hi, eps2_lo,
        int(guarded), scratch.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), cg._stream(rhi))
    cg.LAUNCHES["rows_df"] += 1
    cg._check_launch(lib, code, "rows_accel_df")
    return out[0].to(_F64) + out[1].to(_F64)


def rows_jerk_df_kernel(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm_hi,
                        gm_lo, eps2_hi, eps2_lo, guarded=True):
    """Launch K11 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``rows_jerk_df_plain``."""
    nr, ns = rhi.shape[0], shi.shape[0]
    _check_operands(
        nr, ns, dict(rows_hi=rhi, rows_lo=rlo, vel_rows_hi=vhi,
                     vel_rows_lo=vlo),
        dict(src_hi=shi, src_lo=slo, src_vel_hi=svhi, src_vel_lo=svlo),
        gm_hi, gm_lo)
    lib = cg._library()
    f32 = torch.float32
    scratch = torch.empty((lib.ocn_rows_jerk_df_scratch(nr, ns),), dtype=f32,
                          device=rhi.device)
    out = torch.empty((4, nr, 3), dtype=f32, device=rhi.device)
    code = lib.ocn_rows_jerk_df(
        rhi.data_ptr(), rlo.data_ptr(), vhi.data_ptr(), vlo.data_ptr(), nr,
        shi.data_ptr(), slo.data_ptr(), svhi.data_ptr(), svlo.data_ptr(),
        gm_hi.data_ptr(), gm_lo.data_ptr(), ns, eps2_hi, eps2_lo,
        int(guarded), scratch.data_ptr(), *(o.data_ptr() for o in out),
        cg._stream(rhi))
    cg.LAUNCHES["rows_jerk_df"] += 1
    cg._check_launch(lib, code, "rows_jerk_df")
    out = out.to(_F64)
    return out[0] + out[1], out[2] + out[3]


def eft_selftest_kernel(a, b, xh, xl):
    """``eft_selftest_plain`` by the device's own transforms
    (``csrc/df.cuh``), on f32 CUDA vectors of one length."""
    n = a.shape[0]
    for name, t in dict(a=a, b=b, x_hi=xh, x_lo=xl).items():
        cg._check_f32(name, t, (n,))
    lib = cg._library()
    out = torch.empty((6, n), dtype=torch.float32, device=a.device)
    code = lib.ocn_df_selftest(a.data_ptr(), b.data_ptr(), xh.data_ptr(),
                               xl.data_ptr(), n, out.data_ptr(),
                               cg._stream(a))
    cg._check_launch(lib, code, "df_selftest")
    return tuple(out.unbind(0))


# --------------------------------------------------------------------------
# public wrappers (pallas_df's signatures: f64 state in and out)
# --------------------------------------------------------------------------

def _check_resident(n: int) -> None:
    if n > cg.STREAM_N:
        raise NotImplementedError(
            f"N = {n} exceeds STREAM_N = {cg.STREAM_N}: the two-float "
            "kernels hold their sources resident, as the TPU kernels do, "
            "and the JAX package has no streamed form of them to port "
            "(ROADMAP B10: the df32 tier past STREAM_N)")


def accel_df(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Two-float self-interaction accel; f64 in, pos.dtype out (K10)."""
    _check_resident(pos.shape[0])
    hi, lo, *rest = df32._df_prepare(pos, mass, eps, G)
    if cg._on_cuda(hi, lo, rest[0], rest[1]):
        acc = rows_df_kernel(hi, lo, hi, lo, *rest, guarded)
    else:
        acc = rows_df_plain(hi, lo, hi, lo, *rest, guarded=guarded)
    return acc.to(pos.dtype)


def accel_jerk_df(pos, vel, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Two-float self-interaction (accel, jerk); f64 in, pos.dtype out
    (K11)."""
    _check_resident(pos.shape[0])
    hi, lo, gm_hi, gm_lo, e2h, e2l, vhi, vlo = df32._df_prepare(
        pos, mass, eps, G, vel=vel)
    planes = (hi, lo, vhi, vlo)
    if cg._on_cuda(*planes, gm_hi, gm_lo):
        acc, jerk = rows_jerk_df_kernel(*planes, *planes, gm_hi, gm_lo, e2h,
                                        e2l, guarded)
    else:
        acc, jerk = rows_jerk_df_plain(*planes, *planes, gm_hi, gm_lo, e2h,
                                       e2l, guarded=guarded)
    return acc.to(pos.dtype), jerk.to(pos.dtype)
