"""Host-side phase timing and the program's spans (counterpart of
``oc_nbody_tpu/utils/profiling.py``).

``Stopwatch`` times named phases on the host clock. On a CUDA device each
phase ends with ``torch.cuda.synchronize``, so a phase's time includes the
device work it enqueued; fences sit only at phase boundaries, never inside
the step loop. Each phase is also a span named ``run.<phase>``.

Spans. ``with span(name): ...`` marks a stretch of host time where the
work happens (the names, and the metric each is for, are in PERF.md §3).
The recorder is on exactly while a ``torch.profiler`` runs
(``torch.autograd.profiler._is_profiler_enabled``) and has no other
switch. Off, ``span`` returns one shared no-op object after one flag
check: no clock read, no allocation, no device work. On, each span appends
one ``SpanRecord`` to a bounded buffer (the oldest go first) as it closes:
its name, its id, its parent's id (the span open on the same thread when
it began), its host start and end in ns on ``clock_ns`` (``time.time_ns``,
the clock the profiler's events carry), and its attributes (``bytes``
handed between shards, the ``site`` of a wait; for a tile of pair work,
its ``pairs``, the ``form`` of that work, as ``bench_torch/roofline.py``'s
``FLOPS_PER_PAIR`` keys it, and the ``particles`` it reads). With
``device=`` a CUDA device, a span also records a timing event on that
device's current stream at entry and at exit (no sync); its device
milliseconds are resolved when ``spans()`` reads it. No span launches a
kernel, a copy or a memset.

Every span whose name ends in ``.wait`` blocks the host on a card: the
one device read of a Hermite step or block micro-step, the row's three
syncs and its copy, the Stopwatch's fence.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 20
clock_ns = time.time_ns

_records = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_open = threading.local()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span; ``device_ms`` is None without device events."""
    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int
    bytes: int | None
    site: str | None
    device_ms: float | None
    pairs: int | None = None
    form: str | None = None
    particles: int | None = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("id", "name", "parent", "start_ns", "end_ns", "bytes",
                 "site", "device", "events", "device_ms", "pairs", "form",
                 "particles")

    def __init__(self, name, device, moves, site, pairs, form, particles):
        self.name = name
        self.bytes = None if moves is None else _nbytes(moves)
        self.site = site
        self.pairs = pairs
        self.form = form
        self.particles = particles
        self.device = (device if device is not None and device.type == "cuda"
                       else None)
        self.events = None
        self.device_ms = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if self.device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = [start]
        self.start_ns = clock_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = clock_ns()
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.events.append(end)
        _open.stack.pop()
        _records.append(self)
        return False

    def record(self) -> SpanRecord:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self.events = None
        return SpanRecord(self.id, self.name, self.parent, self.start_ns,
                          self.end_ns, self.bytes, self.site, self.device_ms,
                          self.pairs, self.form, self.particles)


def _nbytes(moves) -> int:
    if isinstance(moves, torch.Tensor):
        return moves.nbytes
    return sum(_nbytes(m) for m in moves)


def span(name: str, device: torch.device | None = None, moves=None,
         site: str | None = None, pairs: int | None = None,
         form: str | None = None, particles: int | None = None):
    """A span ``name`` (a context manager), recorded only while a
    torch.profiler runs. ``device``: a CUDA device on whose current stream
    the span's device time is taken too; ``moves``: the tensors (a tensor,
    or lists and tuples of them) the span hands from shard to shard, whose
    bytes it records; ``site``: where a ``.wait`` span blocks; ``pairs``,
    ``form``, ``particles``: a tile's pair interactions, the form of its
    pair work and the particles it reads."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, moves, site, pairs, form, particles)


def spans() -> list:
    """The recorded spans, oldest first, as ``SpanRecord``s with their
    device milliseconds resolved (which waits for their end events). Their
    times are ns on ``clock_ns``."""
    return [s.record() for s in list(_records)]


class Stopwatch:
    """Named phase timings, fenced on ``device`` when it is a CUDA device;
    each phase is a span ``run.<phase>``, each fence a ``run.wait``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            with span("run.wait", site="stopwatch"):
                torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(f"run.{name}"):
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
