"""Bytes handed between shards per step: the ``bytes`` of the program's
``parallel.exchange`` spans inside its ``integrator.step`` spans (the
positions and masses cut into shards, each ring hop's slabs, the
outputs gathered), counted whether or not two shards share a card, over
the ``integrator.step`` spans in the traced window. None on a program
without spans."""
from bench_torch import program_spans

LAYER = "force model and kernels"
MOVES = "sim_myr_per_s.sharded"
UNIT = "bytes"


def read(run):
    spans = program_spans.read(run)
    if spans is None:
        return None
    steps = spans.named("integrator.step")
    if not steps:
        return None
    moved = sum(s.bytes or 0 for s in spans.named("parallel.exchange")
                if spans.under(s, "integrator.step"))
    return moved / len(steps)
