"""Times of the register-blocked pair-symmetric kernels on the card, at the
sizes the main path gives them, one JSON line each: K2 (sym_accel), K12
(cross_accel), K6 (sym_accel_x), K15 (cross_accel_x), K13 (cross_jerk) and
K16 (cross_jerk_x), and beside them K3 (sym_jerk) and K7 (sym_jerk_x), the
diagonal chunks of the jerk routes. Each line carries a digest of the
launch's output bits (the first 16 hex digits of a SHA-256 over its
tensors), so that a call that times two checkouts shows which kernels
give the same bits in both.

    python3 sym_kernel_times.py                  # this checkout's kernels
    python3 sym_kernel_times.py --tree DIR       # the package under DIR
    python3 sym_kernel_times.py --sweep          # also every tile geometry

``--tree`` imports ``oc_nbody_tpu_torch`` from another checkout (an older
commit unpacked with ``git archive``), so that two versions are timed on one
card in one call: run old, new, new, old. ``--sweep`` times K2, K12, K6,
K15, K13 and K16 in each compiled geometry (R rows a thread, S column
parts; ``cuda_gravity.GEOMETRIES``), where the checkout's wrapper takes
one. K2 runs at N = 8,192 (c2,
``SYM_MIN``), 32,768 (a halfring shard), 65,536 (the north star), 131,072
(c5, c6's diagonal chunk) and 262,144 (``STREAM_N``); K12 at c6's chunk
pair 131,072^2, its ragged pair 131,072 x 82,496, and 32,768^2 and
16,384^2; K6 at 8,192 (``SYM_MIN``), 65,536 (c6x's ragged last chunk),
98,304 (``CHUNK_SYMX``), 131,072 (c5x) and 262,144; K15 at c6x's chunk
pair 98,304^2 and its ragged pair 98,304 x 65,536; K13 at c3's jerk chunk
pair at 1M, 98,304^2, and its ragged pair
98,304 x 65,536; K16 at c3x's, 73,728^2 and 73,728 x 16,384; K3 at 98,304
and K7 at 73,728 (``CHUNK_SYMJ``, ``CHUNK_SYMXJ``). Inputs are Plummer
spheres made from a seed, eps = 1/512 unguarded, as chip_smoke.py times
them. A time is the median of five launches (CUDA events) after 50 ms of
warm-up launches, so that the first size is not timed at an idle clock.
Needs a card; exits 1 without one.
"""
import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SYM_NS = (8192, 32768, 65536, 131072, 262144)
CROSS = ((131072, 131072), (131072, 82496), (32768, 32768), (16384, 16384))
SYM_X_NS = (8192, 65536, 98304, 131072, 262144)
CROSS_X = ((98304, 98304), (98304, 65536))
CROSS_JERK = ((98304, 98304), (98304, 65536))
CROSS_JERK_X = ((73728, 73728), (73728, 16384))
SYM_JERK_N = 98304
SYM_JERK_X_N = 73728
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


def _digest(out):
    """The first 16 hex digits of a SHA-256 over the output tensors' bits."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32, prepare_x
    dev = torch.device("cuda")
    card = _card()
    wrapper = {"sym": cg.sym_kernel, "cross": cg.cross_kernel,
               "sym_x": cg.sym_x_kernel, "cross_x": cg.cross_x_kernel,
               "cross_jerk": cg.cross_jerk_kernel,
               "cross_jerk_x": cg.cross_jerk_x_kernel}

    def geoms(key):
        takes = key in wrapper and "geometry" in inspect.signature(
            wrapper[key]).parameters
        return cg.GEOMETRIES if args.sweep and takes else (None,)

    def emit(**kw):
        print(json.dumps(dict(label=args.label, card=card, **kw)),
              flush=True)

    def state(n, seed):
        return plummer(n, torch.Generator().manual_seed(seed), device=dev)

    def time_each(key, shape, launch, with_phi=(False,)):
        for g in geoms(key):
            kw = {} if g is None else dict(geometry=g)
            for phi in with_phi:
                digest = _digest(launch(phi, kw))
                ms = _median_ms(lambda: launch(phi, kw))
                emit(kernel=key + ("_phi" if phi else ""), shape=shape,
                     geometry=list(g) if g else None, ms=ms, digest=digest)
            torch.cuda.empty_cache()

    for n in SYM_NS:
        st = state(n, 12)
        pos, mass = prepare_f32(st.pos, st.mass)
        del st
        time_each("sym", [n], lambda phi, kw: cg.sym_kernel(
            pos, mass, EPS, with_phi=phi, guarded=False, **kw), (False, True))
        del pos, mass
    for nA, nB in CROSS:
        st = state(nA + nB, 41)
        pos, mass = prepare_f32(st.pos, st.mass)
        del st
        pA, pB = pos[:nA].contiguous(), pos[nA:].contiguous()
        mA, mB = mass[:nA].contiguous(), mass[nA:].contiguous()
        del pos, mass
        time_each("cross", [nA, nB], lambda phi, kw: cg.cross_kernel(
            pA, pB, mA, mB, EPS, with_phi=phi, guarded=False, **kw),
            (False, True))
    for n in SYM_X_NS:
        st = state(n, 22)
        hi, lo, gm = prepare_x(st.pos, st.mass, 1.0)
        del st
        time_each("sym_x", [n], lambda phi, kw: cg.sym_x_kernel(
            hi, lo, gm, EPS, with_phi=phi, guarded=False, **kw),
            (False, True))
        del hi, lo, gm
    for nA, nB in CROSS_X:
        st = state(nA + nB, 47)
        planes = prepare_x(st.pos, st.mass, 1.0)
        del st
        args_ = (*(t[a:b].contiguous() for a, b in ((0, nA), (nA, nA + nB))
                   for t in planes[:2]),
                 *(planes[2][a:b].contiguous()
                   for a, b in ((0, nA), (nA, nA + nB))))
        del planes
        time_each("cross_x", [nA, nB], lambda phi, kw: cg.cross_x_kernel(
            *args_, EPS, with_phi=phi, guarded=False, **kw), (False, True))
        del args_
    st = state(sum(CROSS_JERK[0]), 42)
    pos, mass, vel = prepare_f32(st.pos, st.mass, vel=st.vel)
    del st
    p, v, m = (t[:SYM_JERK_N].contiguous() for t in (pos, vel, mass))
    time_each("sym_jerk", [SYM_JERK_N], lambda phi, kw: cg.sym_jerk_kernel(
        p, v, m, EPS, guarded=False))
    del p, v, m
    for nA, nB in CROSS_JERK:
        args_ = tuple(t[a:b].contiguous() for t, (a, b) in zip(
            (pos, vel, pos, vel, mass, mass),
            ((0, nA), (0, nA), (nA, nA + nB), (nA, nA + nB), (0, nA),
             (nA, nA + nB))))
        time_each("cross_jerk", [nA, nB], lambda phi, kw: cg.cross_jerk_kernel(
            *args_, EPS, guarded=False, **kw))
        del args_
    del pos, mass, vel
    st = state(sum(CROSS_JERK_X[0]), 48)
    hi, lo, gm, vhi, vlo = prepare_x(st.pos, st.mass, 1.0, vel=st.vel)
    del st
    planes = tuple(t[:SYM_JERK_X_N].contiguous()
                   for t in (hi, lo, vhi, vlo, gm))
    time_each("sym_jerk_x", [SYM_JERK_X_N],
              lambda phi, kw: cg.sym_jerk_x_kernel(*planes, EPS,
                                                   guarded=False))
    del planes
    for nA, nB in CROSS_JERK_X:
        sets = [tuple(t[a:b].contiguous() for t in (hi, lo, vhi, vlo))
                for a, b in ((0, nA), (nA, nA + nB))]
        args_ = (*sets[0], *sets[1], gm[:nA].contiguous(),
                 gm[nA:nA + nB].contiguous())
        time_each("cross_jerk_x", [nA, nB],
                  lambda phi, kw: cg.cross_jerk_x_kernel(
                      *args_, EPS, guarded=False, **kw))
        del sets, args_
    return 0


if __name__ == "__main__":
    sys.exit(main())
