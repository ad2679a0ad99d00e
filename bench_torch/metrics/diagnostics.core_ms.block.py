"""``diagnostics.core_ms`` in the block-step cells, which report their own
end-to-end metrics (``sim_myr_per_s.block``): the same reader."""
from bench_torch.harness import reader

LAYER = "diagnostics"
MOVES = "sim_myr_per_s.block"
UNIT = "ms"
read = reader("diagnostics.core_ms").read
