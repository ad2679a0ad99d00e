"""``integrator.launches_per_step`` in the block-step cells, which report their
own end-to-end metrics (``sim_myr_per_s.block``): the same reader."""
from bench_torch.harness import reader

LAYER = "integrator"
MOVES = "sim_myr_per_s.block"
UNIT = "count"
read = reader("integrator.launches_per_step").read
