"""``device.idle_in_wait_pct`` in the cells across cards, which report their
own end-to-end metrics (``sim_myr_per_s.sharded``): the same reader."""
from bench_torch.harness import reader

LAYER = "device"
MOVES = "sim_myr_per_s.sharded"
UNIT = "%"
read = reader("device.idle_in_wait_pct").read
