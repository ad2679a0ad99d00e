"""Host microseconds per block micro-step blocked on the micro-step's one
read of (t_next, n_active): the program's ``integrator.wait`` spans over
its ``integrator.step`` spans in the traced window (host clock; the
profiler's cost on each launch is in it). None on a program without
spans."""
from bench_torch import program_spans

LAYER = "integrator"
MOVES = "sim_myr_per_s.block"
UNIT = "us"


def read(run):
    spans = program_spans.read(run)
    if spans is None:
        return None
    steps = spans.named("integrator.step")
    if not steps:
        return None
    waited = sum(s.seconds for s in spans.named("integrator.wait"))
    return 1e6 * waited / len(steps)
