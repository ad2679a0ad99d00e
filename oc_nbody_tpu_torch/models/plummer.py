"""Plummer-sphere initial conditions, sampled with an explicit
``torch.Generator`` (counterpart of ``oc_nbody_tpu/models/plummer.py``).

The Aarseth–Hénon–Wielen (1974) recipe, as in the JAX package:

  * radius: M(<r) uniform in (0, cutoff)  =>  r = a (u^{-2/3} - 1)^{-1/2}
  * speed:  v = q v_esc(r) with q drawn by rejection from
    g(q) = q^2 (1-q^2)^{7/2}
  * isotropic directions for both.

Sampling runs on the CPU in f64 (the generator's stream is then the same
on every device) and the state is moved to ``device`` at the end. The same
generator seed gives a bitwise-equal IC; the stream is not JAX's, so the
two packages' ICs agree statistically, not bit for bit.
"""
from __future__ import annotations

import math

import torch

from oc_nbody_tpu_torch.state import ParticleState, make_state

_F64 = torch.float64
# Plummer scale radius in Hénon (virial) units: r_vir = 16/(3 pi) a
A_HENON = 3.0 * math.pi / 16.0
# Half-mass radius in units of a: r_h = a / sqrt(2^{2/3} - 1) ≈ 1.30477 a
HALF_MASS_RADIUS_OVER_A = 1.0 / (2.0 ** (2.0 / 3.0) - 1.0) ** 0.5


def _uniform(gen, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=_F64)


def _isotropic(gen, n):
    """n random unit vectors, (n, 3)."""
    z = _uniform(gen, n, -1.0, 1.0)
    phi = _uniform(gen, n, 0.0, 2.0 * math.pi)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=1)


def _sample_q(gen, n, n_rounds: int = 24):
    """Rejection-sample q in (0,1) from g(q) = q^2 (1-q^2)^{7/2}.

    Fixed-shape batched rejection, as in the JAX package: each round draws a
    full batch of candidates and keeps the first acceptance per slot
    (acceptance ≈ 0.098 per draw; 24 rounds leave a miss probability
    < 1e-24 per slot, and misses fall back to the mode)."""
    gmax = 0.0935  # > max_q g(q) = (2/9)(7/9)^{7/2} ≈ 0.09222
    q = torch.full((n,), math.sqrt(2.0 / 9.0) * math.sqrt(2.0), dtype=_F64)
    accepted = torch.zeros(n, dtype=torch.bool)
    for _ in range(n_rounds):
        qc = _uniform(gen, n, 0.0, 1.0)
        uc = _uniform(gen, n, 0.0, gmax)
        ok = uc < qc * qc * (1.0 - qc * qc) ** 3.5
        q = torch.where(ok & ~accepted, qc, q)
        accepted |= ok
    return q


def plummer(n: int, gen: torch.Generator, a: float | None = None,
            total_mass: float = 1.0, G: float = 1.0,
            cutoff_mass_fraction: float = 0.999,
            device=None) -> ParticleState:
    """Sample an N-particle, equal-mass Plummer sphere in virial equilibrium.

    Args:
      n: number of particles.
      gen: a CPU torch.Generator (same seed -> bitwise-same IC).
      a: Plummer scale radius; default 3π/16 gives Hénon units (virial
         radius 1, E = -1/4) when total_mass = G = 1.
      total_mass: cluster mass in code units.
      G: gravitational constant in code units.
      cutoff_mass_fraction: truncate the outermost mass fraction so a finite
        sample has no huge-radius outliers (standard practice).
      device: where the state lives.
    """
    if a is None:
        a = A_HENON
    u = _uniform(gen, n, 0.0, cutoff_mass_fraction)
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _isotropic(gen, n)

    # escape speed at r: v_esc^2 = 2 G M / sqrt(r^2 + a^2)
    vesc = math.sqrt(2.0 * G * total_mass) * (r * r + a * a) ** (-0.25)
    q = _sample_q(gen, n)
    vel = (q * vesc)[:, None] * _isotropic(gen, n)

    mass = torch.full((n,), total_mass / n, dtype=torch.float32)
    state = make_state(pos, vel, mass)
    # remove the (small, finite-N) centre-of-mass drift, on the CPU so the
    # IC is bitwise the same whatever the device
    state = state.replace(pos=state.pos - state.com(),
                          vel=state.vel - state.com_vel())
    return state.to(device) if device is not None else state
