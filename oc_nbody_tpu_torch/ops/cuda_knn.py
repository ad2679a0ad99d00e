"""The CH85 k-th-nearest-neighbour sweep on the card (the diagnostics row's
core density, ``diagnostics.local_density``), beside its plain twin.

  * K22 ``csrc/knn_density.cu`` — per probe, the k-th smallest distinct
    positive f32 squared distance to the sources and the summed mass at
    the k - 1 smaller distinct distances, each probe's k slots held in
    registers, one thread sweeping every source. Replaces no TPU kernel:
    the JAX package's ``local_density`` (oc_nbody_tpu/diagnostics.py:148)
    is one jnp program that XLA fuses, and eager PyTorch ran it as ~22
    launches per chunk of 256 probes.

``knn_density`` takes the probes and sources as ``local_density`` strides,
centres and casts them (f32, one frame) and the sources' stride-scaled f32
masses, and returns (rk2, mnb), both f32 per probe: K22 for CUDA tensors,
the plain twin ``knn_density_plain`` (the chunk loop of k threshold passes,
the JAX package's tie semantics) for CPU tensors; there is no fallback from
one to the other. ``cuda_gravity.LAUNCHES`` / ``PLAIN_CALLS`` count both
under ``knn_density``. K22 is compiled for ``KNN_KS``; another k raises on
the card.
"""
from __future__ import annotations

import math

import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.utils.profiling import span

# the k K22 is compiled for (diagnostics.core_radius_density's default)
KNN_KS = (6,)


def knn_density_plain(probes, src, msrc, k: int, chunk: int = 256):
    """K22's function in plain PyTorch: k threshold passes over each chunk
    of probes' f32 d² to the sources. Exact-duplicate distances collapse to
    one rank and all tied masses count; d² <= 0 (self and coincident pairs)
    is excluded as +inf. Returns (rk2, mnb): the k-th distinct d² (+inf
    with fewer than k) and the mass at or inside the (k-1)-th."""
    cg.PLAIN_CALLS["knn_density"] += 1
    with span("diagnostics.wait", site="local_density.inf"):
        inf = torch.tensor(math.inf, dtype=torch.float32, device=src.device)
    rk2, mnb = [], []
    for i0 in range(0, probes.shape[0], chunk):
        p = probes[i0:i0 + chunk]
        d2 = torch.sum((p[:, None, :] - src[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(d2 <= 0.0, inf, d2)  # self pairs
        thr = torch.min(d2, dim=1).values     # rank-1 distance²
        thr_prev = thr
        for _ in range(k - 1):
            thr_prev = thr
            thr = torch.min(torch.where(d2 <= thr[:, None], inf, d2),
                            dim=1).values     # next rank
        mnb.append(torch.sum(torch.where(d2 <= thr_prev[:, None],
                                         msrc[None, :], 0.0), dim=1))
        rk2.append(thr)
    return torch.cat(rk2), torch.cat(mnb)


def knn_density_kernel(probes, src, msrc, k: int):
    """Launch K22 on f32 CUDA tensors; the same contract as
    ``knn_density_plain``."""
    if k not in KNN_KS:
        raise ValueError(f"K22 is compiled for k in {KNN_KS}, not k = {k}")
    np_, ns = probes.shape[0], src.shape[0]
    cg._check_f32("probes", probes, (np_, 3))
    cg._check_f32("src", src, (ns, 3))
    cg._check_f32("msrc", msrc, (ns,))
    lib = cg._library()
    src4 = torch.cat((src, msrc[:, None]), dim=1)
    rk2 = torch.empty((np_,), dtype=torch.float32, device=probes.device)
    mnb = torch.empty((np_,), dtype=torch.float32, device=probes.device)
    code = lib.ocn_knn_density(probes.data_ptr(), np_, src4.data_ptr(), ns,
                               k, rk2.data_ptr(), mnb.data_ptr(),
                               cg._stream(probes))
    cg.LAUNCHES["knn_density"] += 1
    cg._check_launch(lib, code, "knn_density")
    return rk2, mnb


def knn_density(probes, src, msrc, k: int, chunk: int = 256):
    """(rk2, mnb) per probe: K22 for CUDA tensors, the plain twin (in
    chunks of ``chunk`` probes) for CPU tensors."""
    if cg._on_cuda(probes, src, msrc):
        return knn_density_kernel(probes, src, msrc, k)
    return knn_density_plain(probes, src, msrc, k, chunk)
