"""The step's pair work against the cards' kernel time: the least time one
card could take for the pair work of the traced steps (``roofline.py``,
from the shapes and the step count alone, whatever kernel does the work)
over the time in which the cards ran operations launched in ``step``
spans, summed over the cards. Rows are excluded."""
from bench_torch import kinds, timeline

LAYER = "force model and kernels"
MOVES = "sim_myr_per_s"
UNIT = "%"


def read(run):
    if run.trace is None or not run.steps:
        return None
    busy = sum(timeline.covered(run.trace.busy(d, "step"))
               for d in range(run.trace.devices))
    if busy <= 0:
        return None
    least, _ = kinds.least_seconds(run.kind, run.n, run.steps,
                                   run.n_active_sum, run.evaluations)
    return 100.0 * least / busy
