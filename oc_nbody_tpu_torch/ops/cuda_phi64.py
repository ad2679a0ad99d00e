"""The float64 pair potential of the diagnostics row on the card
(``output.diag_f64``, ``diagnostics.pair_and_external_phi``), beside its
plain twin.

  * K23 ``csrc/phi_f64.cu`` — phi_i = -G sum_{j != i} m_j (r_ij² +
    eps²)^-1/2, every pair in f64, R rows a thread in registers against
    source tiles in shared memory, the sources split over a second grid
    dimension and the split sums added in a fixed order. Replaces no TPU
    kernel: the JAX package's f64 row is its plain jnp oracle
    (oc_nbody_tpu/diagnostics.py:pair_and_external_phi), and eager PyTorch
    ran it as 256 chunks of (512, N) f64 temporaries at N = 131,072.

``potential`` takes the state's f64 positions and its masses and returns
phi per particle in f64, the self term removed: K23 for CUDA tensors, the
plain twin ``potential_plain`` (``gravity.potential`` in f64, row chunks of
512) for CPU tensors; there is no fallback from one to the other.
``cuda_gravity.LAUNCHES`` / ``PLAIN_CALLS`` count both under ``phi_f64``.
"""
from __future__ import annotations

import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.ops.gravity import rounded

_F64 = torch.float64


def _check(pos, mass):
    n = pos.shape[0]
    if pos.dtype != _F64:
        raise TypeError(f"pos must be float64, got {pos.dtype}")
    if mass.dtype not in (torch.float32, _F64):
        raise TypeError(f"mass must be float32 or float64, got {mass.dtype}")
    if tuple(pos.shape) != (n, 3) or tuple(mass.shape) != (n,):
        raise ValueError(f"pos must have shape (n, 3) and mass (n,); got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if not (pos.is_contiguous() and mass.is_contiguous()):
        raise ValueError("pos and mass must be contiguous")


def potential_plain(pos, mass, eps, G=1.0, chunk: int = 512):
    """K23's function in plain PyTorch: ``gravity.potential`` in f64, in
    row chunks of ``chunk``."""
    cg.PLAIN_CALLS["phi_f64"] += 1
    return gravity.potential(pos, mass, eps, G, compute_dtype=_F64,
                             chunk=chunk)


def potential_kernel(pos, mass, eps, G=1.0):
    """Launch K23 on CUDA tensors, on the operands ``gravity.potential``
    prepares (positions centred in f64, G·m, eps² and 1/eps in f64); the
    contract of ``potential_plain``."""
    _check(pos, mass)
    n = pos.shape[0]
    pos_c, mass_c = gravity.prepare_f32(pos, mass, compute_dtype=_F64)
    src = torch.cat((pos_c, (rounded(G, _F64) * mass_c)[:, None]), dim=1)
    eps = rounded(eps, _F64)
    eps2 = rounded(eps ** 2, _F64)
    inv_eps = rounded(1.0 / eps, _F64) if eps > 0 else 0.0
    lib = cg._library()
    part = torch.empty((lib.ocn_phi_f64_scratch(n),), dtype=_F64,
                       device=pos.device)
    phi = torch.empty((n,), dtype=_F64, device=pos.device)
    with cg.on_device(pos.device):
        code = lib.ocn_phi_f64(src.data_ptr(), n, eps2, inv_eps,
                               int(eps2 < torch.finfo(_F64).tiny),
                               part.data_ptr(), phi.data_ptr(),
                               cg._stream(pos))
    cg.LAUNCHES["phi_f64"] += 1
    cg._check_launch(lib, code, "phi_f64")
    return phi


def potential(pos, mass, eps, G=1.0):
    """phi per particle in f64, the self term removed: K23 for CUDA
    tensors, the plain twin for CPU tensors."""
    _check(pos, mass)
    if cg._on_cuda(pos, mass):
        return potential_kernel(pos, mass, eps, G)
    return potential_plain(pos, mass, eps, G)
