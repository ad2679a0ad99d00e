#!/usr/bin/env python3
"""Smoke test of the PyTorch port (oc_nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from the sources in the checkout (one nvcc per
   source, all at once);
3. each kernel (K1 rows_accel, K2 sym_accel, K3 sym_jerk, K4 rows_jerk)
   against its plain PyTorch twin in f64 on the same inputs, with max
   error, tolerance and times (CUDA events, median of 5) for the kernel and
   the f32 plain twin; K2 and K3 are launched twice and must be bitwise
   equal;
4. the paths, each through ``python -m oc_nbody_tpu_torch run`` (via
   ``__main__.main``) with the launch counters set to 0 just before it and
   read just after: c1 (KDK, K1), the north star (KDK, K2), c2 (King IC,
   KDK, K2) and c3 (Kroupa IMF, Hermite, K3) at full N and full length,
   and c3 cut to N = 4,096 and t_end = 1 (Hermite, K4). Only the older
   paths' t_end (c1, the north star) is cut, and the cut printed, if the
   runs would not fit the time budget. Each path must launch its kernel,
   the plain twins must not run, no diagnostic may be NaN, and the drift
   must stay inside its bound; c2 must strip 5-40% of its bound mass;
5. the steps of c2 (KDK) and c3 (Hermite) alone: ms/step, for Hermite
   also without the per-step read of the shared dt (the cost of that
   device sync), and the device's busy time per step under torch.profiler
   over the unprofiled step time.

Then the card's name and power limit, one JSON line with the kernels'
numbers, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
C3 = "configs/c3_hermite_16k_kroupa.toml"
# path name -> (config, overrides, the kernel it must launch)
PATHS = {
    "c1": ("configs/c1_plummer_1k.toml", [], "rows"),
    "north_star": ("configs/north_star_65k_orbit.toml", [], "sym"),
    "c2": ("configs/c2_king_8k_circular.toml", [], "sym"),
    "c3": (C3, [], "sym_jerk"),
    "c3_n4096": (C3, ["ic.n=4096", "output.t_end=1.0"], "rows_jerk"),
}
# only these paths' t_end is cut if the runs would not fit the budget
CUTTABLE = ("c1", "north_star")
# the script must finish in 1200 s with the build included
BUDGET_S = 1000.0
DRIFT_BOUND = {"c1": ("dE_over_E", 1e-6),
               "north_star": ("dE_over_E_int", 1e-5),
               "c2": ("dE_over_E_int", 1e-5),
               "c3": ("dE_over_E", 1e-6),
               "c3_n4096": ("dE_over_E", 1e-6)}
# c2's bound mass stripped over the run: the JAX package's recorded run
# stripped 18.3% (RESULTS.md:713); outside this range the tide is broken
STRIP_RANGE = (0.05, 0.40)
# steps the JAX package's c3 run took to t = 10 (RESULTS.md:714): the
# Hermite run-time estimate scales 50 timed steps by this rate
HERMITE_STEPS_PER_TIME = 60516 / 10.0
# H100 SXM peaks for the kernels' bounds: f32 FMA pipe, MUFU rsqrt
# (16/clk/SM x 132 SMs x 1.98 GHz), HBM3
PEAK_FLOPS = 66.9e12
PEAK_RSQRT = 4.2e12
PEAK_BYTES = 3.35e12
# f32 flops per pair for the bounds, counted from the kernels' pair
# functions (an FMA as 2, the rsqrt apart): one-sided accel 18 and 19 with
# phi (pair.cuh:row_pair), accel+jerk 41 (pair.cuh:row_jerk_pair);
# pair-symmetric, per unique pair, accel 26 and 28 with phi
# (sym_accel.cu:sym_pair), accel+jerk 53 (sym_jerk.cu:sym_jerk_pair)
FLOPS_PER_PAIR = {"rows": 18, "rows_phi": 19, "rows_jerk": 41,
                  "sym": 26, "sym_phi": 28, "sym_jerk": 53}


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _median_ms(fn, reps=5):
    import torch
    fn()  # warm-up
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


def _cluster(n, seed, device):
    """Centred f32 positions and masses of a Hénon-unit Plummer sphere."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    return prepare_f32(state.pos, state.mass)


def _compare(out, ref, with_phi, tol_a):
    """(max |da|, max |da| / max |a|, max rel phi error) against the f64
    reference; raises past the tolerances."""
    acc, ref_acc = (out[0], ref[0]) if with_phi else (out, ref)
    err = float((acc.double() - ref_acc).abs().max())
    scale = float(ref_acc.abs().max())
    if not err <= tol_a * scale:
        raise AssertionError(f"accel error {err:.3e} > {tol_a:g} * "
                             f"max|a| = {tol_a * scale:.3e}")
    phi_rel = 0.0
    if with_phi:
        phi_rel = float(((out[1].double() - ref[1]).abs()
                         / ref[1].abs()).max())
        if not phi_rel <= 3e-5:
            raise AssertionError(f"phi relative error {phi_rel:.3e} > 3e-5")
    return err, err / scale, phi_rel


def _moving_cluster(n, seed, device):
    """Centred f32 positions, masses and velocities of a Hénon-unit Plummer
    sphere."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    return prepare_f32(state.pos, state.mass, vel=state.vel)


def _compare_jerk(out, ref, tol_a, tol_j):
    """(max |da|, max |da| / max |a|, max |dj| / max |j|) against the f64
    reference; raises past the tolerances."""
    errs = []
    for got, want, tol, name in ((out[0], ref[0], tol_a, "accel"),
                                 (out[1], ref[1], tol_j, "jerk")):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{name} error {err:.3e} > {tol:g} * "
                                 f"max = {tol * scale:.3e}")
        errs.append((err, err / scale))
    return errs[0][0], errs[0][1], errs[1][1]


def _bound(pairs, flops_per_pair, nbytes):
    """(ms, 'bytes' or 'operations'): the least time an H100 SXM could take
    for the work — the larger of the bytes moved over HBM bandwidth and
    the operations (f32 flops, one rsqrt per pair) over their peaks."""
    t_ops = max(pairs * flops_per_pair / PEAK_FLOPS, pairs / PEAK_RSQRT)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(cg, device):
    """Phase 3; returns {kernel: dict(max_abs_err, ms, plain_ms, shape,
    bound_ms, bound_by)} at the main paths' shapes (K1: c1's N = 1024, K2:
    the north star's 65,536, K3: c3's 16,384, K4: the N = 4,096 Hermite
    run), and the potential forms of K1 and K2 at their kernels' shapes.
    Work per call for the bounds: FLOPS_PER_PAIR and one rsqrt per pair;
    inputs read and outputs written once."""
    import torch
    main = {}
    print("kernel      shape            phi  eps        max|da|    "
          "rel      phi_rel    ms        plain_ms")
    # (65536, 65536): K1 on the north star's self-interaction, the time
    # K2 is measured against (the H100 SYM_MIN crossover is unmeasured)
    for nr, ns in ((1000, 1000), (1024, 1024), (4096, 65536),
                   (65536, 65536)):
        src, mass = _cluster(ns, 11, device)
        rows = src[:nr].contiguous()
        tol = 2e-5 if ns >= 65536 else 5e-6
        for with_phi in (False, True):
            for eps in (0.0, 1.0 / 512):
                kw = dict(with_phi=with_phi, guarded=eps == 0.0)
                out = cg.rows_kernel(rows, src, mass, eps, **kw)
                ref = cg.rows_plain(rows, src, mass, eps, with_phi=with_phi,
                                    dtype=torch.float64)
                err, rel, prel = _compare(out, ref, with_phi, tol)
                ms = _median_ms(lambda: cg.rows_kernel(rows, src, mass, eps,
                                                       **kw))
                pms = _median_ms(lambda: cg.rows_plain(
                    rows, src, mass, eps, with_phi=with_phi))
                print(f"rows_accel  ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
                      f"{int(with_phi):<5}{eps:<11.6g}{err:<11.3e}"
                      f"{rel:<9.2e}{prel:<11.2e}{ms:<10.4f}{pms:.4f}")
                if (nr, ns, eps) == (1024, 1024, 1.0 / 512):
                    key = "rows_phi" if with_phi else "rows"
                    main[key] = dict(
                        max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                        bound=_bound(nr * ns, FLOPS_PER_PAIR[key],
                                     16 * ns + (28 if with_phi else 24) * nr))
    for n in (8191, 8192, 65536, 262144):
        pos, mass = _cluster(n, 12, device)
        tol = 2e-5 if n >= 65536 else 5e-6
        eps = 1.0 / 512
        chunk = 256 if n > 65536 else 1024
        for with_phi in (False, True):
            out = cg.sym_kernel(pos, mass, eps, with_phi=with_phi,
                                guarded=False)
            again = cg.sym_kernel(pos, mass, eps, with_phi=with_phi,
                                  guarded=False)
            same = (torch.equal(out[0], again[0])
                    and torch.equal(out[1], again[1])) if with_phi \
                else torch.equal(out, again)
            if not same:
                raise AssertionError(f"sym_accel N={n} phi={with_phi}: two "
                                     "launches differ bitwise")
            ref = cg.sym_plain(pos, mass, eps, with_phi=with_phi,
                               dtype=torch.float64, chunk=chunk)
            err, rel, prel = _compare(out, ref, with_phi, tol)
            del ref
            ms = _median_ms(lambda: cg.sym_kernel(pos, mass, eps,
                                                  with_phi=with_phi,
                                                  guarded=False))
            pms = _median_ms(lambda: cg.sym_plain(pos, mass, eps,
                                                  with_phi=with_phi,
                                                  chunk=chunk))
            print(f"sym_accel   ({n}){'':<{13 - len(str(n))}}"
                  f"{int(with_phi):<5}{eps:<11.6g}{err:<11.3e}{rel:<9.2e}"
                  f"{prel:<11.2e}{ms:<10.4f}{pms:.4f}   bitwise-repeatable")
            if n == 65536:
                key = "sym_phi" if with_phi else "sym"
                main[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, shape=[n],
                    bound=_bound(n * (n - 1) // 2, FLOPS_PER_PAIR[key],
                                 (32 if with_phi else 28) * n))
            torch.cuda.empty_cache()

    print("kernel      shape            eps        max|da|    rel_a    "
          "rel_j    ms        plain_ms")
    # K3: accel 5e-6 and jerk 1e-5 of max at N <= 16,384, 2e-5 at 65,536
    for n in (8191, 16384, 65536):
        pos, mass, vel = _moving_cluster(n, 13, device)
        tol_a, tol_j = (2e-5, 2e-5) if n >= 65536 else (5e-6, 1e-5)
        for eps in (0.0, 1.0 / 256):
            guarded = eps == 0.0
            out = cg.sym_jerk_kernel(pos, vel, mass, eps, guarded=guarded)
            again = cg.sym_jerk_kernel(pos, vel, mass, eps, guarded=guarded)
            if not all(torch.equal(a, b) for a, b in zip(out, again)):
                raise AssertionError(f"sym_jerk N={n} eps={eps}: two "
                                     "launches differ bitwise")
            ref = cg.sym_jerk_plain(pos, vel, mass, eps, dtype=torch.float64)
            err, rel_a, rel_j = _compare_jerk(out, ref, tol_a, tol_j)
            del ref
            ms = _median_ms(lambda: cg.sym_jerk_kernel(pos, vel, mass, eps,
                                                       guarded=guarded))
            pms = _median_ms(lambda: cg.sym_jerk_plain(pos, vel, mass, eps))
            print(f"sym_jerk    ({n}){'':<{13 - len(str(n))}}"
                  f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
                  f"{ms:<10.4f}{pms:.4f}   bitwise-repeatable", flush=True)
            if (n, eps) == (16384, 1.0 / 256):
                main["sym_jerk"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, shape=[n],
                    bound=_bound(n * (n - 1) // 2,
                                 FLOPS_PER_PAIR["sym_jerk"], 52 * n))
            torch.cuda.empty_cache()
    # K4: the same tolerances by source count
    for nr, ns in ((1000, 1000), (4096, 4096), (4096, 65536)):
        src, mass, svel = _moving_cluster(ns, 14, device)
        rows, vrows = src[:nr].contiguous(), svel[:nr].contiguous()
        tol_a, tol_j = (2e-5, 2e-5) if ns >= 65536 else (5e-6, 1e-5)
        for eps in (0.0, 1.0 / 256):
            guarded = eps == 0.0
            out = cg.rows_jerk_kernel(rows, vrows, src, svel, mass, eps,
                                      guarded=guarded)
            ref = cg.rows_jerk_plain(rows, vrows, src, svel, mass, eps,
                                     dtype=torch.float64)
            err, rel_a, rel_j = _compare_jerk(out, ref, tol_a, tol_j)
            del ref
            ms = _median_ms(lambda: cg.rows_jerk_kernel(
                rows, vrows, src, svel, mass, eps, guarded=guarded))
            pms = _median_ms(lambda: cg.rows_jerk_plain(rows, vrows, src,
                                                        svel, mass, eps))
            print(f"rows_jerk   ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
                  f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
                  f"{ms:<10.4f}{pms:.4f}", flush=True)
            if (nr, ns, eps) == (4096, 4096, 1.0 / 256):
                main["rows_jerk"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                    bound=_bound(nr * ns, FLOPS_PER_PAIR["rows_jerk"],
                                 28 * ns + 48 * nr))
    print("kernel     shape           ms        bound_ms   bound_by    "
          "share of bound")
    for key, m in main.items():
        b_ms, b_by = m["bound"]
        print(f"{key:<11}{str(m['shape']):<16}{m['ms']:<10.4f}{b_ms:<11.5f}"
              f"{b_by:<12}{b_ms / m['ms']:.1%}")
    return main


def _load(name):
    from oc_nbody_tpu_torch.config import apply_overrides, load_config
    path, over, _ = PATHS[name]
    return apply_overrides(load_config(os.path.join(ROOT, path)), over)


def _estimate_s(cfg, device):
    """Seconds one full run of cfg should take: 50 timed steps and one
    timed diagnostics row, scaled to the run's step and row counts (for
    Hermite, the JAX package's c3 step rate)."""
    import torch
    from oc_nbody_tpu_torch import diagnostics
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    scene = build_scene(cfg, device)
    stepper, kind = make_stepper(cfg, scene.force)
    carry = stepper.advance(stepper.init(scene.state), 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry = stepper.advance(carry, 50)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t) / 50
    t = time.perf_counter()
    diagnostics.compute_all(carry.state, scene.force, cfg.output.fractions)
    torch.cuda.synchronize()
    per_row = time.perf_counter() - t
    out = cfg.output
    n_rows = math.ceil(out.t_end / out.diag_every) + 1
    steps = (out.t_end * HERMITE_STEPS_PER_TIME if kind == "hermite"
             else out.t_end / cfg.integrator.dt)
    return steps * per_step + n_rows * per_row


def run_main_path(cg, device, budget_s):
    """Phase 4: the CLI on every path, each with the launch counters set to
    0 just before it and read just after; returns ({name: RunResult},
    {name: launches})."""
    import numpy as np
    import oc_nbody_tpu_torch.run as run_mod
    from oc_nbody_tpu_torch.__main__ import main as cli_main
    from oc_nbody_tpu_torch.utils.profiling import interactions_per_sec

    est = {k: _estimate_s(_load(k), device) for k in PATHS}
    print("estimated full-length run time: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in est.items())
          + f" (budget {budget_s:.0f} s)")
    fixed = sum(v for k, v in est.items() if k not in CUTTABLE)
    scale = min(1.0, max(0.0, budget_s - fixed)
                / sum(est[k] for k in CUTTABLE))
    overrides = {k: list(over) for k, (_, over, _) in PATHS.items()}
    if scale < 1.0:
        for k in CUTTABLE:
            out = _load(k).output
            cut = out.diag_every * max(1, math.floor(
                out.t_end * scale / out.diag_every))
            overrides[k].append(f"output.t_end={cut!r}")
            print(f"CUT: {k} output.t_end {out.t_end} -> {cut} to fit the "
                  "time budget (N unchanged)")

    # record the RunResult that the CLI's run() returns
    results = []
    real_run = run_mod.run

    def recording_run(*args, **kw):
        res = real_run(*args, **kw)
        results.append(res)
        return res

    run_mod.run = recording_run
    runs, launches = {}, {}
    try:
        for k, (path, _, want) in PATHS.items():
            print(f"--- main path: python -m oc_nbody_tpu_torch run {path} "
                  f"--device cuda "
                  f"{' '.join('--set ' + o for o in overrides[k])}",
                  flush=True)
            argv = ["run", os.path.join(ROOT, path), "--device", "cuda"]
            for o in overrides[k]:
                argv += ["--set", o]
            for key in cg.LAUNCHES:
                cg.LAUNCHES[key] = 0
            for key in cg.PLAIN_CALLS:
                cg.PLAIN_CALLS[key] = 0
            if cli_main(argv) != 0:
                raise AssertionError(f"{k}: the CLI returned non-zero")
            launches[k] = dict(cg.LAUNCHES)
            runs[k] = results[-1]
            print(f"{k}: kernel launches {launches[k]}, plain-twin calls "
                  f"{cg.PLAIN_CALLS}", flush=True)
            if launches[k][want] <= 0:
                raise AssertionError(f"{k}: the {want} kernel never launched")
            if any(cg.PLAIN_CALLS.values()):
                raise AssertionError(f"{k}: plain twins ran on the path: "
                                     f"{cg.PLAIN_CALLS}")
    finally:
        run_mod.run = real_run
    for k, res in runs.items():
        n = res.state.n
        for name in ("pos", "vel"):
            t = getattr(res.state, name)
            if tuple(t.shape) != (n, 3) or not bool(t.isfinite().all()):
                raise AssertionError(f"{k}: final {name} not finite (n, 3)")
        nan_cols = [c for c, v in res.diagnostics.items() if np.isnan(v).any()]
        if nan_cols:
            raise AssertionError(f"{k}: NaN in diagnostics {nan_cols}")
        col, bound = DRIFT_BOUND[k]
        drift = float(np.abs(res.diagnostics[col]).max())
        advance_s = res.phase_s["advance"]
        rate = interactions_per_sec(n, res.n_steps, advance_s)
        print(f"{k}: N={n} steps={res.n_steps} t={res.state.time:.6g} "
              f"max|{col}|={drift:.3e} (bound {bound:g})  "
              f"{advance_s / res.n_steps * 1e3:.4f} ms/step  "
              f"{rate:.4e} N^2-equivalent interactions/s  "
              f"run {res.wall_time_s:.1f} s", flush=True)
        if not drift <= bound:
            raise AssertionError(f"{k}: max|{col}| = {drift:.3e} > {bound:g}")
    mb = runs["c2"].diagnostics["M_bound"]
    stripped = 1.0 - mb[-1] / mb[0]
    print(f"c2: bound mass {mb[0]:.6g} -> {mb[-1]:.6g}: {stripped:.2%} "
          f"stripped (of the total mass: "
          f"{1.0 - mb[-1] / float(runs['c2'].state.total_mass):.2%}; the "
          "JAX package's recorded run: 18.3%)", flush=True)
    if not STRIP_RANGE[0] <= stripped <= STRIP_RANGE[1]:
        raise AssertionError(f"c2: stripped {stripped:.2%} outside "
                             f"{STRIP_RANGE}: the tide is broken")
    return runs, launches


def measure_steps(device, n_steps=200):
    """Phase 5, off the main path: the step of c2 (KDK) and c3 (Hermite) on
    the card. Times n_steps steps on the host clock; for Hermite also
    without the per-step read of the shared dt (the same device work
    through ``Hermite4.propose`` at the carried dt, one sync at the end),
    in turns. The device's busy time per step comes from torch.profiler
    over 100 steps; its busy share is that over the unprofiled step time
    (the profiler slows the host)."""
    import torch
    from oc_nbody_tpu_torch.integrators.hermite import HermiteCarry
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name in ("c2", "c3"):
        cfg = _load(name)
        scene = build_scene(cfg, device)
        stepper, kind = make_stepper(cfg, scene.force)
        carry = stepper.advance(stepper.init(scene.state), 20)

        def no_read(c):
            x1, v1, a1, j1, _ = stepper.propose(c, c.dt)
            return HermiteCarry(
                state=c.state.replace(pos=x1, vel=v1,
                                      time=c.state.time + c.dt),
                acc=a1, jerk=j1, dt=c.dt, n_steps=c.n_steps + 1)

        def timed(step):
            c = carry
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n_steps):
                c = step(c)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / n_steps * 1e3

        if kind == "hermite":   # in turns: read, no read, no read, read
            read = [timed(stepper.step)]
            free = [timed(no_read), timed(no_read)]
            read.append(timed(stepper.step))
        else:
            read, free = [timed(stepper.step), timed(stepper.step)], []
        ms = statistics.mean(read)
        c = carry
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(100):
                c = stepper.step(c)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 100 / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        line = (f"{name} {kind} step (N={scene.state.n}, {n_steps} steps per "
                f"timing): {ms:.4f} ms/step "
                f"({', '.join(f'{x:.4f}' for x in read)})")
        if free:
            ms_free = statistics.mean(free)
            line += (f" with the per-step dt read, {ms_free:.4f} ms/step "
                     f"without it ({', '.join(f'{x:.4f}' for x in free)}): "
                     f"the read costs {ms - ms_free:.4f} ms/step")
            out[name + "_read_ms"] = ms - ms_free
        print(line)
        print(f"{name} device busy {busy_ms:.4f} ms/step (profiler, 100 "
              f"steps) = {busy_ms / ms:.1%} of the step, idle "
              f"{1 - busy_ms / ms:.1%}; kernels per step "
              f"{sum(e.count for e in kernels) / 100:.1f}; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 100:.1f}"
                          f" us/step" for e in top), flush=True)
        out[name + "_busy"] = busy_ms / ms
        del scene, stepper, carry, c
        torch.cuda.empty_cache()
    return out


def main():
    t_start = time.perf_counter()
    if not os.path.isfile(os.path.join(ROOT, "oc_nbody_tpu_torch",
                                       "__init__.py")):
        _fail("the oc_nbody_tpu_torch package is not beside this script")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        _fail("torch sees no CUDA device; this smoke test needs one GPU")
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip()
    print(smi_line)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    t = time.perf_counter()
    cg._library()
    print(f"kernel build: {time.perf_counter() - t:.2f} s "
          f"({cg.build_library().name})")
    for line in cg.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())

    main_shapes = check_kernels(cg, device)
    budget = BUDGET_S - (time.perf_counter() - t_start)
    runs, launches = run_main_path(cg, device, budget)
    measure_steps(device)

    kernels = []
    for key, name, src, rep, also in (
            ("rows", "rows_accel", "oc_nbody_tpu_torch/csrc/rows_accel.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:110",
             "oc_nbody_tpu/ops/pallas_gravity.py:199"),
            ("sym", "sym_accel", "oc_nbody_tpu_torch/csrc/sym_accel.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_P)"),
            ("sym_jerk", "sym_jerk", "oc_nbody_tpu_torch/csrc/sym_jerk.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_J, _pair_jerk :137)",
             None),
            ("rows_jerk", "rows_jerk", "oc_nbody_tpu_torch/csrc/rows_jerk.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:294", None)):
        m = main_shapes[key]
        bound_ms, bound_by = m["bound"]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(n[key] for n in launches.values()),
                 "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "shape": m["shape"]}
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
