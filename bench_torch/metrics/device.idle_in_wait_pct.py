"""Of the cards' idle time in the traced window, the share during which
the host was blocked on a card: inside any of the program's spans whose
name ends in ``.wait`` (the micro-step's read, the row's copy, ...).
Each card's idle time is the gaps between its operations in the window
(``trace.busy``); the idle time under a wait is summed over the cards and
divided by all their idle time. A card idle while the host waits is held
back by a sync; one idle while the host is not waiting is held back by the
host's own work (launches, Python). None on a program without spans."""
from bench_torch import program_spans, timeline

LAYER = "device"
MOVES = "sim_myr_per_s"
UNIT = "%"


def read(run):
    spans = program_spans.read(run)
    if spans is None:
        return None
    waits = timeline.union((s.start, s.end) for s in spans.spans
                           if s.name.endswith(".wait"))
    lo, hi = run.trace.window
    idle = under = 0.0
    for d in range(run.trace.devices):
        gaps = timeline.gaps(run.trace.busy(d), lo, hi)
        idle += timeline.covered(gaps)
        under += program_spans.overlap(gaps, waits)
    return 100.0 * under / idle if idle > 0 else None
