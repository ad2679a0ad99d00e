"""The chunked self-interaction's tiles against their roofline, read from
the program's spans: past one resident set the port evaluates the pair
force as diagonal chunks (``force.diag``, the pair-symmetric kernel on one
chunk) and chunk pairs (``force.cross``, the cross kernel on two), each
span holding its kernel alone, timed by CUDA events on the particles'
stream, and counting its ``pairs``, the ``form`` of its pair work (a key
of ``roofline.FLOPS_PER_PAIR``) and the ``particles`` it reads.

A share is the least time of the tiles' work, ``roofline.bound(pairs,
FLOPS_PER_PAIR[form], 28 x particles)`` summed over the tiles (the bytes
of ``roofline.self_interaction``: positions and masses in, accel out; the
operations bound a tile of 131,072 stars some 3,000 times over), over
their device seconds. Only tiles inside ``integrator.step`` spans count:
those of the row's pair potential lie under ``diagnostics.pair_phi``.
None, never raising, where there is nothing to read: no trace, no
recorder, no such tile in the window, or a tile without its counters (a
program older than them) or its device time, or of a form the roofline
does not count.
"""
from __future__ import annotations

from bench_torch import program_spans, roofline

BYTES_PER_PARTICLE = 28


def roofline_pct(run, name: str) -> float | None:
    """The tiles named ``name`` in ``run``'s traced steps: their least
    time over their device time, in %; or None."""
    spans = program_spans.read(run)
    if spans is None:
        return None
    records = {r.id: r for r in program_spans._records() or ()}
    least = seconds = 0.0
    for s in spans.named(name):
        if not spans.under(s, "integrator.step"):
            continue
        r = records.get(s.id)
        pairs = getattr(r, "pairs", None)
        form = getattr(r, "form", None)
        particles = getattr(r, "particles", None)
        if (pairs is None or particles is None or s.device_ms is None
                or form not in roofline.FLOPS_PER_PAIR):
            return None
        t, _ = roofline.bound(pairs, roofline.FLOPS_PER_PAIR[form],
                              BYTES_PER_PARTICLE * particles)
        least += t
        seconds += s.device_ms * 1e-3
    if seconds <= 0:
        return None
    return 100.0 * least / seconds
