"""Run one cell of the port's benchmark once, on the cards of this machine.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the run's lines and, last, one JSON
object (correct, attempted, failed, metrics, device[, breakdown], compared);
the numbers compared and their limits are also the last lines on standard
error. Exits 2, printing no result, without as many CUDA cards as the cell
asks for, and 3 where JAX or the JAX package is loaded in the process
once the run is over, naming on standard error what it found. The kernels' build (``build/oc_nbody_tpu_torch/``) and any
kernel cache stay in fixed directories inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_torch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_torch import harness
    cell = harness.load_cell(args.workload, harness.load_benchmark(ROOT))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s), {seen} visible: "
              "no result (the benchmark does not run on the CPU)",
              file=sys.stderr)
        return 2
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             T_START)
    except harness.JaxLoaded as e:
        print(e, file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
