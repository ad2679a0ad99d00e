"""The program's own spans in a traced run, on the device trace's clock.

While the run's profiler runs, ``oc_nbody_tpu_torch.utils.profiling``
records the spans the program opens where its work happens (PERF.md §3
names them): host start and end in ns on ``profiling.clock_ns``, a
parent, the bytes a span hands between shards, the device milliseconds of
the row's parts. ``read(run)`` returns those that overlap the traced
window, in seconds, or None: with no trace, with no recorder in the
program (a program older than its spans: no ``profiling.spans``), or with
no span in the window. It never raises, and it imports the program only
when called; every reader of a program span goes through it and returns
None where it does.

One clock. The recorder's host clock is the one the profiler stamps its
events with (``time.time_ns``), and at the start of a window the two agree
to within the launch latency (PERF.md §3). Should they not (no
``integrator.step`` starting inside the device's first ``step`` span, or
up to ``SLACK`` before it), the host times are first shifted by the gap
between the first ``integrator.step`` and that span's start. Within a
window the device's timestamps wander against the host's by tens of
microseconds (a slow drift, and a jump where the profiler re-syncs them),
enough to move a 200 us read off its copy. So the host's reads anchor the
two clocks: each ``.wait`` span that ends within ``MAX_SKEW`` of a
device-to-host copy's end is an anchor, its lag the wait's end less the
copy's. The wander at an anchor is the median lag of its ``NEIGHBOURS``
neighbours on either side less the median lag of all anchors; host times
between anchors are moved by the wander interpolated between them (and by
the nearest anchor's beyond them). The median latency of a read is kept;
with fewer than two anchors nothing moves.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics

SLACK = 1e-3       # s a host span may start before its mark runs (launch)
MAX_SKEW = 5e-4    # s between a read's end and its copy's, at most
NEIGHBOURS = 16    # anchors on either side in a wander's median


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    id: int
    parent: int | None
    start: float            # s, on the trace's clock
    end: float
    seconds: float          # the host duration, from the ns readings
    bytes: int | None
    site: str | None
    device_ms: float | None


@dataclasses.dataclass
class Spans:
    spans: list             # Span in the window, by start
    by_id: dict             # every recorded span, by id
    shift: float            # s added to the recorder's clock
    anchors: list           # (host s, lag s) of each anchoring read

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def under(self, span: Span, name: str) -> bool:
        """Whether a span named ``name`` encloses ``span`` (its parent, or
        the parent's, ...)."""
        p = self.by_id.get(span.parent)
        while p is not None:
            if p.name == name:
                return True
            p = self.by_id.get(p.parent)
        return False


def _records():
    """The recorder's SpanRecords, or None without a recorder."""
    try:
        from oc_nbody_tpu_torch.utils import profiling
        return list(profiling.spans())
    except Exception:       # an older program: no recorder, or another one
        return None


def _shift(records, trace) -> float:
    """Seconds to add to the recorder's times to put them on the trace's
    clock: 0 where they agree already."""
    steps = sorted((r.start_ns * 1e-9 for r in records
                    if r.name == "integrator.step"))
    first = trace.spans.get(0, [])
    first = next(((s, e) for name, s, e in first if name == "step"), None)
    if not steps or first is None:
        return 0.0
    lo, hi = first
    inside = [t for t in steps if lo - SLACK <= t <= hi]
    if inside:
        return 0.0
    return lo - steps[0]


def _anchors(spans, trace) -> list:
    """(host end, lag) of every ``.wait`` span ending within ``MAX_SKEW``
    of a device-to-host copy's end (the nearest), by host end."""
    ends = sorted(o.end for o in trace.ops
                  if o.kind == "memcpy" and "DtoH" in o.name)
    out = []
    for s in sorted((s for s in spans if s.name.endswith(".wait")),
                    key=lambda s: s.end):
        i = bisect.bisect_left(ends, s.end)
        near = min((ends[j] for j in (i - 1, i) if 0 <= j < len(ends)),
                   key=lambda e: abs(e - s.end), default=None)
        if near is not None and abs(s.end - near) <= MAX_SKEW:
            out.append((s.end, s.end - near))
    return out


def _wander(anchors):
    """t -> seconds the device's clock has wandered at host time t, from
    the anchors (zero with fewer than two)."""
    if len(anchors) < 2:
        return lambda t: 0.0
    times = [t for t, _ in anchors]
    lags = [lag for _, lag in anchors]
    mid = statistics.median(lags)
    off = [statistics.median(lags[max(0, k - NEIGHBOURS):k + NEIGHBOURS + 1])
           - mid for k in range(len(lags))]

    def at(t):
        i = bisect.bisect_left(times, t)
        if i == 0:
            return off[0]
        if i == len(times):
            return off[-1]
        t0, t1 = times[i - 1], times[i]
        w = (t - t0) / (t1 - t0) if t1 > t0 else 0.0
        return off[i - 1] + w * (off[i] - off[i - 1])
    return at


def _place(records, trace):
    """Spans of ``records`` on the trace's clock: (by id, shift,
    anchors)."""
    shift = _shift(records, trace)
    by_id = {r.id: Span(name=r.name, id=r.id, parent=r.parent,
                        start=r.start_ns * 1e-9 + shift,
                        end=r.end_ns * 1e-9 + shift,
                        seconds=(r.end_ns - r.start_ns) * 1e-9,
                        bytes=r.bytes, site=r.site, device_ms=r.device_ms)
             for r in records}
    anchors = _anchors(by_id.values(), trace)
    wander = _wander(anchors)
    by_id = {i: dataclasses.replace(s, start=s.start - wander(s.start),
                                    end=s.end - wander(s.end))
             for i, s in by_id.items()}
    return by_id, shift, anchors


def read(run) -> Spans | None:
    """The program's spans overlapping ``run``'s traced window, or None."""
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    records = _records()
    if not records:
        return None
    try:
        by_id, shift, anchors = _place(records, trace)
        lo, hi = trace.window
    except Exception:       # records of another shape
        return None
    inside = sorted((s for s in by_id.values() if s.end > lo and s.start < hi),
                    key=lambda s: s.start)
    if not inside:
        return None
    return Spans(spans=inside, by_id=by_id, shift=shift, anchors=anchors)


def overlap(a, b) -> float:
    """Total length of the intersection of two sorted lists of merged
    (start, end) intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def mean_device_ms(run, name: str) -> float | None:
    """The mean device milliseconds of the spans ``name`` in ``run``'s
    traced window, or None."""
    spans = read(run)
    if spans is None:
        return None
    ms = [s.device_ms for s in spans.named(name) if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
