"""``diagnostics.core_ms`` in the cells across cards, which report their own
end-to-end metrics (``sim_myr_per_s.sharded``): the same reader."""
from bench_torch.harness import reader

LAYER = "diagnostics"
MOVES = "sim_myr_per_s.sharded"
UNIT = "ms"
read = reader("diagnostics.core_ms").read
