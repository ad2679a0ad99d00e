"""Times of the pair-symmetric kernels K2 (sym_accel) and K12 (cross_accel)
on the card, at the sizes the main path gives them, one JSON line each.

    python3 sym_kernel_times.py                  # this checkout's kernels
    python3 sym_kernel_times.py --tree DIR       # the package under DIR
    python3 sym_kernel_times.py --sweep          # also every tile geometry

``--tree`` imports ``oc_nbody_tpu_torch`` from another checkout (an older
commit unpacked with ``git archive``), so that two versions are timed on one
card in one call: run old, new, new, old. ``--sweep`` times K2 and K12 in
each compiled geometry (R rows a thread, S column parts;
``cuda_gravity.GEOMETRIES``), which only a checkout that has them offers.
K2 runs at N = 8,192 (c2, ``SYM_MIN``), 32,768 (a halfring shard), 65,536
(the north star), 131,072 (c5, c6's diagonal chunk) and 262,144
(``STREAM_N``); K12 at c6's chunk pair 131,072^2, its ragged pair 131,072 x
82,496, and 32,768^2 and 16,384^2. Inputs are Plummer spheres made from a
seed, eps = 1/512 unguarded, as chip_smoke.py times them. A time is the
median of five launches (CUDA events) after 50 ms of warm-up launches, so
that the first size is not timed at an idle clock. Needs a card; exits
1 without one.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SYM_NS = (8192, 32768, 65536, 131072, 262144)
CROSS = ((131072, 131072), (131072, 82496), (32768, 32768), (16384, 16384))
EPS = 1.0 / 512


def _median_ms(fn, reps=5):
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:  # the card at its load clock
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("sym_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32
    dev = torch.device("cuda")
    card = _card()
    geoms = cg.GEOMETRIES if args.sweep else (None,)

    def emit(**kw):
        print(json.dumps(dict(label=args.label, card=card, **kw)),
              flush=True)

    def cluster(n, seed):
        state = plummer(n, torch.Generator().manual_seed(seed), device=dev)
        return prepare_f32(state.pos, state.mass)

    for n in SYM_NS:
        pos, mass = cluster(n, 12)
        for g in geoms:
            kw = {} if g is None else dict(geometry=g)
            for with_phi in (False, True):
                ms = _median_ms(lambda: cg.sym_kernel(
                    pos, mass, EPS, with_phi=with_phi, guarded=False, **kw))
                emit(kernel="sym_phi" if with_phi else "sym", shape=[n],
                     geometry=list(g) if g else None, ms=ms)
            torch.cuda.empty_cache()
        del pos, mass
    for nA, nB in CROSS:
        pos, mass = cluster(nA + nB, 41)
        pA, pB = pos[:nA].contiguous(), pos[nA:].contiguous()
        mA, mB = mass[:nA].contiguous(), mass[nA:].contiguous()
        del pos, mass
        for g in geoms:
            kw = {} if g is None else dict(geometry=g)
            for with_phi in (False, True):
                ms = _median_ms(lambda: cg.cross_kernel(
                    pA, pB, mA, mB, EPS, with_phi=with_phi, guarded=False,
                    **kw))
                emit(kernel="cross_phi" if with_phi else "cross",
                     shape=[nA, nB], geometry=list(g) if g else None, ms=ms)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
