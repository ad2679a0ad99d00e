"""Host-side phase timing (counterpart of ``oc_nbody_tpu/utils/profiling.py``).

``Stopwatch`` times named phases on the host clock. On a CUDA device each
phase ends with ``torch.cuda.synchronize``, so a phase's time includes the
device work it enqueued; fences sit only at phase boundaries, never inside
the step loop.
"""
from __future__ import annotations

import contextlib
import time

import torch


class Stopwatch:
    """Named phase timings, fenced on ``device`` when it is a CUDA device."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.fence()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {tot:9.3f}s  x{n}  "
                         f"({tot / n * 1e3:.2f} ms/call)")
        return "\n".join(lines)


def interactions_per_sec(n: int, n_force_evals: int, wall_s: float) -> float:
    """N² pairwise interactions per force evaluation, per second (the
    N²-equivalent rate: a pair-symmetric kernel computes N²/2 pairs)."""
    return n * n * n_force_evals / wall_s
