"""The chunk pairs of the steps' chunked self-interaction (K12 on f32
steps) against their roofline: the least time of their pair work over
their device time, from the program's ``force.cross`` spans inside
``integrator.step`` (``tiles.py``). None on a program without those spans
or their counters, and on a cell whose steps are not chunked."""
from bench_torch import tiles

LAYER = "force model and kernels"
MOVES = "sim_myr_per_s"
UNIT = "%"


def read(run):
    return tiles.roofline_pct(run, "force.cross")
