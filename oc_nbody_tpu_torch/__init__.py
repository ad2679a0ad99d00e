"""oc_nbody_tpu_torch — the open-cluster direct N-body engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``oc_nbody_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference every ported part is tested against. The module layout
mirrors the JAX package's, so each counterpart is found by path. Ported so
far: the fixed-dt KDK main path (c1 and the N=65,536 north star) with its
diagnostics; ROADMAP.md lists what follows.

Precision policy, as in the reference: positions and velocities are f64,
masses f32; the O(N²) pairwise force runs in f32 on cluster-centred
offsets. This package imports torch and never jax.
"""

__version__ = "0.1.0"
