"""Share of the segment in which a card ran no operation: one minus the
seconds in which it ran operations in the traced segment (the union of
their intervals) over the host seconds of the run's fenced, untraced
segment of the same work; the mean over the cards the cell uses.

The traced segment's own length is not the denominator: even tracing the
cards alone, the profiler slows the host's launches (about 2.5 us each),
which stretches a host-bound segment (c4's block steps: 12.3 s traced
against 6.4 s), while the device's operations keep their durations."""
LAYER = "device"
MOVES = "sim_myr_per_s"
UNIT = "%"


def read(run):
    if run.trace is None or not run.busy_s or run.untraced_s <= 0:
        return None
    idle = [1.0 - b / run.untraced_s for b in run.busy_s]
    return 100.0 * sum(idle) / len(idle)
