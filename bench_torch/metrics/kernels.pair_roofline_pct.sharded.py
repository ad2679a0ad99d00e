"""``kernels.pair_roofline_pct`` in the cells across cards, which report their
own end-to-end metrics (``sim_myr_per_s.sharded``): the same reader."""
from bench_torch.harness import reader

LAYER = "force model and kernels"
MOVES = "sim_myr_per_s.sharded"
UNIT = "%"
read = reader("kernels.pair_roofline_pct").read
