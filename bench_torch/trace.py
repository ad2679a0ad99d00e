"""The traced window: torch.profiler over the cards alone, read into device
operations and the harness's spans.

The profiler records no host activity: recording every host operation
slows the host enough to make it the window's bottleneck, and the idle
share would then measure the profiler. The spans come from the device
instead. As the host enters a span (``step``, ``restore``, ``row``) and as
the window ends, the harness puts a mark on each card's current stream: a
kernel that spins for a few cycles (``torch.cuda._sleep``, whose kernel no
program launches). On each card, an operation belongs to the span whose
mark last started before it, and the card's window runs from its first
mark to the end of its last. A card goes idle only once it has run all the
host launched, the last mark among it, so an idle gap lies in the span the
host was in. Times are seconds on the profiler's device clock, which the
cards share.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

from bench_torch import timeline

SPANS = ("step", "row", "restore")
END = "end"
MARK = "spin_kernel"
MARK_CYCLES = 64


def profiler(cuda: bool):
    """A torch.profiler over the cards; on the CPU, none (no device)."""
    if not cuda:
        return contextlib.nullcontext()
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


class Marker:
    """Marks each span, and the window's end, on every card's current
    stream; ``names`` keeps their order."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.names = []

    def mark(self, name: str) -> None:
        self.names.append(name)
        for d in self.devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(MARK_CYCLES)

    def span(self, name: str):
        self.mark(name)
        return contextlib.nullcontext()


@dataclasses.dataclass
class DeviceOp:
    device: int
    name: str
    kind: str          # kernel, memcpy or memset
    start: float
    end: float
    span: str          # the span it ran in, or "other"


@dataclasses.dataclass
class Trace:
    spans: dict        # card -> [(name, start, end)], sorted by start
    ops: list          # DeviceOp, marks left out
    devices: int       # cards the window used

    @property
    def window(self):
        """(start, end): from the first card's first mark to the last
        card's end mark."""
        return (min(s[0][1] for s in self.spans.values()),
                max(s[-1][2] for s in self.spans.values()))

    def span_at(self, device: int, t: float) -> str:
        spans = self.spans.get(device, [])
        i = bisect.bisect_right([s for _, s, _ in spans], t) - 1
        if i >= 0 and t < spans[i][2]:
            return spans[i][0]
        return "other"

    def busy(self, device: int, span: str | None = None):
        """Merged intervals in which ``device`` ran an operation inside the
        window (in ``span``, when given)."""
        lo, hi = self.window
        iv = [(o.start, o.end) for o in self.ops if o.device == device
              and (span is None or o.span == span)]
        return timeline.clip(timeline.union(iv), lo, hi)

    def kernels(self, span: str | None = None):
        return [o for o in self.ops if o.kind == "kernel"
                and (span is None or o.span == span)]


def _ns(e, what: str) -> int:
    """An event's start or duration in ns, whichever the torch build
    names (``start_ns`` / ``start_us``)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def read(prof, devices: int, names: list) -> Trace | None:
    """The Trace of a finished ``profiler`` whose window the marks
    ``names`` divided; None without a device event."""
    if not isinstance(prof, torch.profiler.profile):
        return None
    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.device_index(), e.name(), _ns(e, "start") * 1e-9,
            _ns(e, "duration") * 1e-9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    return build(raw, devices, names)


def build(raw, devices: int, names: list) -> Trace | None:
    """The Trace of device events ``raw`` ((card, name, start, seconds)):
    each card's marks, in order, open the spans ``names`` (the last,
    ``end``, closes the window). None where a card's marks are not one to
    each name."""
    marks = collections.defaultdict(list)
    ops = []
    for dev, name, start, dur in raw:
        if MARK in name:
            marks[dev].append((start, start + dur))
        elif name not in SPANS:
            ops.append(DeviceOp(device=dev, name=name, kind=_kind(name),
                                start=start, end=start + dur, span="other"))
    if not ops or sorted(marks) != list(range(devices)):
        return None
    spans = {}
    for dev, ms in marks.items():
        ms.sort()
        if len(ms) != len(names) or names[-1] != END:
            return None
        spans[dev] = [(name, s, ms[i + 1][0]) for i, (name, (s, _)) in
                      enumerate(zip(names[:-1], ms[:-1]))]
        spans[dev].append((END, ms[-1][0], ms[-1][1]))
    trace = Trace(spans=spans, ops=ops, devices=devices)
    for o in ops:
        o.span = trace.span_at(o.device, o.start)
        if o.span == END:
            o.span = "other"
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed over the cards)
    and the longest idle gaps of the first card, each cut at the span
    boundaries and named after its span."""
    lo, hi = trace.window
    by_name = collections.Counter()
    for o in trace.ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e > s:
            by_name[o.name] += e - s
    busy = trace.busy(0)
    idle = [(name, e - s) for name, s0, e0 in trace.spans[0] if name != END
            for s, e in timeline.gaps(busy, s0, e0)]
    idle.sort(key=lambda g: g[1], reverse=True)
    return {"device_ops": [[n, t] for n, t in by_name.most_common(top)],
            "idle_gaps": [[n, t] for n, t in idle[:top]]}


def busy_seconds(trace: Trace) -> list:
    """Seconds each card used ran an operation inside the window."""
    return [timeline.covered(trace.busy(d)) for d in range(trace.devices)]
