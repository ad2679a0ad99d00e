"""The cluster centre's orbit: a point under the external field alone,
integrated by classical fourth-order Runge-Kutta on the host.

The pair forces of a cluster add up to nothing, so its centre of mass
moves under the field's mean over the stars, which differs from the field
at the centre by the tide's second order, (r_cluster / R_orbit)^2.
"""
from __future__ import annotations

import math

import torch


def integrate(field, x0, v0, t: float, dtype=torch.float64,
              max_dt: float = 1.0 / 1024):
    """(x, v) after time ``t`` from (x0, v0), computed in ``dtype``."""
    x = torch.as_tensor(x0, dtype=torch.float64).to(dtype).cpu()
    v = torch.as_tensor(v0, dtype=torch.float64).to(dtype).cpu()
    n = max(1, math.ceil(t / max_dt))
    h = torch.tensor(t / n, dtype=dtype)

    def acc(p):
        return field.accel(p[None, :])[0].to(dtype)

    for _ in range(n):
        k1x, k1v = v, acc(x)
        k2x, k2v = v + 0.5 * h * k1v, acc(x + 0.5 * h * k1x)
        k3x, k3v = v + 0.5 * h * k2v, acc(x + 0.5 * h * k2x)
        k4x, k4v = v + h * k3v, acc(x + h * k3x)
        x = x + (h / 6) * (k1x + 2 * k2x + 2 * k3x + k4x)
        v = v + (h / 6) * (k1v + 2 * k2v + 2 * k3v + k4v)
    return x.to(torch.float64), v.to(torch.float64)
