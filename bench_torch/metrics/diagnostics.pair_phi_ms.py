"""Device milliseconds of the row's pairwise potential: the program's
``diagnostics.pair_phi`` span (the f32 pair kernel's potential form, or
the f64 pair sum under ``output.diag_f64``), timed by CUDA events on the
state's stream; the mean over the traced window's rows. None on a
program without spans."""
from bench_torch import program_spans

LAYER = "diagnostics"
MOVES = "sim_myr_per_s"
UNIT = "ms"


def read(run):
    return program_spans.mean_device_ms(run, "diagnostics.pair_phi")
