"""``integrator.launches_per_step`` in the cells across cards, which report
their own end-to-end metrics (``sim_myr_per_s.sharded``): the same reader."""
from bench_torch.harness import reader

LAYER = "integrator"
MOVES = "sim_myr_per_s.sharded"
UNIT = "count"
read = reader("integrator.launches_per_step").read
