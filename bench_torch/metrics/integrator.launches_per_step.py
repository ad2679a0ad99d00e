"""Device kernels per step: the kernels the host launched inside the traced
window's ``step`` spans (CUDA-graph kernels counted one by one), over the
steps (block micro-steps) they took. Rows are not counted."""
LAYER = "integrator"
MOVES = "sim_myr_per_s"
UNIT = "count"


def read(run):
    if run.trace is None or not run.steps:
        return None
    n = len(run.trace.kernels("step"))
    return n / run.steps if n else None
