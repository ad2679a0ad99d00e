"""Device milliseconds of the row's CH85 core: the program's
``diagnostics.core`` span (the kth-nearest-neighbour density sweep and
the core radius and density), timed by CUDA events on the state's stream;
the mean over the traced window's rows. None on a program without
spans."""
from bench_torch import program_spans

LAYER = "diagnostics"
MOVES = "sim_myr_per_s"
UNIT = "ms"


def read(run):
    return program_spans.mean_device_ms(run, "diagnostics.core")
