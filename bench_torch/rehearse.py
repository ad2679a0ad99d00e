"""Rehearse a cell on the CPU, at a tiny star count, through the program's
plain twins: the harness's paths, shapes and result line, no timing.

    python3 bench_torch/rehearse.py --workload <cell> [--n 512]
        [--segment 0.0625] [--seconds 2] [--trace 0|1] [--seed 1]

A cell on several cards runs its shards on the one CPU
(``Mesh.on_one_device``). The result line names the platform "cpu"; no
number it holds is a device metric. The benchmark itself (``run.py``)
refuses to run without a card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--segment", type=float, default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_torch import harness
    from oc_nbody_tpu_torch.parallel.mesh import Mesh
    cell = harness.load_cell(args.workload, harness.load_benchmark(ROOT))
    if args.segment is not None:
        cell = dataclasses.replace(cell, segment=args.segment)
    mesh = Mesh.on_one_device(cell.chips, "cpu") if cell.chips > 1 else None
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START, device="cpu", n=args.n, mesh=mesh)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
