"""Escape pruning: stop feeling forces FROM far-gone tidal-tail stars.

Counterpart of ``oc_nbody_tpu/escape.py``, the NBODY-family "remove
escapers" capability with the JAX package's contract:

* Stars beyond ``escape.r_cut`` tidal radii of the density centre become
  TAIL. Only TAIL–TAIL interactions are dropped: cluster stars feel every
  star, tail stars feel every cluster star plus the external field. Both
  ends of every retained pair feel it, so the reduced system is a genuine
  Hamiltonian (H = KE + every pair except tail–tail + Φ_ext). Pairwise cost:
  N·B (all rows × the cluster bucket) + B·N (the bucket's rows × all
  sources) = 2·B·N, against N².
* Sources are gathered into a power-of-two BUCKET (cluster indices first,
  zero-weight padding that repeats the first member). The power of two is
  XLA's static shapes in the JAX package; the port keeps it so that the
  partition, and with it every pruned evaluation, matches the JAX package's
  exactly. A change of bucket size re-captures the block stepper's CUDA
  graphs, at most O(log N) times a run.
* The partition is a HISTORY-FREE function of the current state (density
  centre and iterated tidal radius, neither of which reads the current
  source set), so a resumed run would recompute the partition the
  uninterrupted run was using.
* Each re-partition changes the Hamiltonian; the driver measures the jump
  (same state, old against new source set) and accounts it in the
  ``E_prune_cum`` ledger, so ``E_tot − E_prune_cum`` drifts only by
  integrator error (the ``dE_cons_over_E_int`` column).

``next_pow2`` and ``build_sources`` are plain numpy, the JAX package's
functions copied; ``partition_inputs`` and ``cluster_mask`` run on the
state's device in f64 and return device tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from oc_nbody_tpu_torch import diagnostics
from oc_nbody_tpu_torch.state import ParticleState


def partition_inputs(state: ParticleState, force):
    """(center, r_t) for the pruning cut, both partition-independent: the
    density centre reads positions and masses only, and the iterated tidal
    radius (``diagnostics.bound_mass_tidal``, the tidal-tensor method)
    positions, masses and the external field. Neither reads the current
    source set."""
    center = diagnostics.density_center(state)
    _, _, r_t, _ = diagnostics.bound_mass_tidal(state, force, center=center)
    return center, r_t


def cluster_mask(state: ParticleState, center, r_cut):
    """Boolean (N,): |r − center| <= r_cut (r_cut already includes the
    tidal-radius factor). An infinite r_cut keeps everything."""
    d = torch.linalg.vector_norm(state.pos.to(torch.float64) - center, dim=1)
    return d <= r_cut


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length()


def build_sources(mask_np: np.ndarray, min_bucket: int):
    """Host-side source-bucket construction from a membership mask.

    Returns (src_idx, src_wgt, n_cluster) as numpy arrays (int32, float32,
    int), or None when pruning buys nothing (the bucket would reach N/2:
    the two pruned sweeps cost 2·B·N, so B must be under N/2 to win) or no
    cluster remains. Padding repeats the FIRST CLUSTER INDEX with weight 0:
    zero-mass sources contribute exactly nothing, and in the
    bucket-rows-×-all-sources sweep the padding rows duplicate a real
    cluster row, so their scattered results are identical duplicate
    writes."""
    n = int(mask_np.shape[0])
    idx = np.nonzero(mask_np)[0].astype(np.int32)
    n_c = int(idx.shape[0])
    if n_c == 0:
        return None
    bucket = max(int(min_bucket), next_pow2(n_c))
    if 2 * bucket >= n:
        return None
    src_idx = np.full(bucket, idx[0], np.int32)
    src_idx[:n_c] = idx
    src_wgt = (np.arange(bucket) < n_c).astype(np.float32)
    return src_idx, src_wgt, n_c
