"""Arithmetic on times: percentiles and unions of intervals."""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals):
    """Sorted, merged (start, end) intervals of possibly overlapping ones."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    """The parts of merged ``intervals`` inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals) -> float:
    """Total length of merged intervals."""
    return sum(e - s for s, e in intervals)


def gaps(intervals, lo, hi):
    """The parts of [lo, hi] that merged ``intervals`` leave uncovered."""
    out, t = [], lo
    for s, e in clip(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
