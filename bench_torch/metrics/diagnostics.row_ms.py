"""Milliseconds per diagnostics row: ``diagnostics.compute_all`` and its
one host copy, on the host clock, the device fenced before it; the mean
over the fenced segment's rows that the traced run makes before its
profiled one (the profiler's own cost left out)."""
LAYER = "diagnostics"
MOVES = "sim_myr_per_s"
UNIT = "ms"


def read(run):
    return run.row_ms
