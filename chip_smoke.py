#!/usr/bin/env python3
"""Smoke test of the PyTorch port (oc_nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from the sources in the checkout (nvcc);
3. each kernel against its plain PyTorch twin in f64 on the same inputs,
   with max error, tolerance and times (CUDA events, median of 5) for the
   kernel and the f32 plain twin; K2 is launched twice and must be bitwise
   equal;
4. the main path: ``python -m oc_nbody_tpu_torch run`` (through
   ``__main__.main``) on configs/c1_plummer_1k.toml and
   configs/north_star_65k_orbit.toml at full N and full length (t_end is
   cut, and the cut printed, only if the runs would not fit the time
   budget). The launch counters must show K1 in c1 and K2 in the north
   star, the plain twins must not run, no diagnostic may be NaN, and the
   drift must stay inside its bound.

Then one JSON line with the kernels' numbers, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = {"c1": "configs/c1_plummer_1k.toml",
           "north_star": "configs/north_star_65k_orbit.toml"}
# the script must finish in 1200 s with the build included
BUDGET_S = 1000.0
DRIFT_BOUND = {"c1": ("dE_over_E", 1e-6),
               "north_star": ("dE_over_E_int", 1e-5)}


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


def check_kernels(cg, device):
    """Phase 3; returns {kernel: (max_abs_err, ms, plain_ms, shape)} at the
    main path's shapes (K1: c1's N = 1024, K2: the north star's 65,536)."""
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
                if (nr, ns, with_phi, eps) == (1024, 1024, False, 1.0 / 512):
                    main["rows"] = (err, ms, pms, [nr, ns])
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
            if (n, with_phi) == (65536, False):
                main["sym"] = (err, ms, pms, [n])
            torch.cuda.empty_cache()
    return main


def _estimate_s(cfg, device):
    """Seconds one full run of cfg should take: 50 timed steps and one
    timed diagnostics row, scaled to the run's step and row counts."""
    import torch
    from oc_nbody_tpu_torch import diagnostics
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    scene = build_scene(cfg, device)
    stepper, _ = make_stepper(cfg, scene.force)
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
    return out.t_end / cfg.integrator.dt * per_step + n_rows * per_row


def run_main_path(cg, device, budget_s):
    """Phase 4: the CLI on both configs; returns {name: RunResult}."""
    import numpy as np
    import oc_nbody_tpu_torch.run as run_mod
    from oc_nbody_tpu_torch.__main__ import main as cli_main
    from oc_nbody_tpu_torch.config import load_config
    from oc_nbody_tpu_torch.utils.profiling import interactions_per_sec

    t_end = {k: load_config(os.path.join(ROOT, p)).output.t_end
             for k, p in CONFIGS.items()}
    est = {k: _estimate_s(load_config(os.path.join(ROOT, p)), device)
           for k, p in CONFIGS.items()}
    print(f"estimated full-length run time: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in est.items())
          + f" (budget {budget_s:.0f} s)")
    scale = min(1.0, budget_s / sum(est.values()))
    overrides = {}
    for k, p in CONFIGS.items():
        if scale < 1.0:
            cfg = load_config(os.path.join(ROOT, p))
            d = cfg.output.diag_every
            cut = d * max(1, math.floor(t_end[k] * scale / d))
            overrides[k] = [f"output.t_end={cut!r}"]
            print(f"CUT: {k} output.t_end {t_end[k]} -> {cut} to fit the "
                  "time budget (N unchanged)")
        else:
            overrides[k] = []

    # record the RunResult that the CLI's run() returns
    results = []
    real_run = run_mod.run

    def recording_run(*args, **kw):
        res = real_run(*args, **kw)
        results.append(res)
        return res

    run_mod.run = recording_run
    for key in cg.LAUNCHES:
        cg.LAUNCHES[key] = 0
    for key in cg.PLAIN_CALLS:
        cg.PLAIN_CALLS[key] = 0
    runs = {}
    try:
        for k, p in CONFIGS.items():
            before = dict(cg.LAUNCHES)
            print(f"--- main path: python -m oc_nbody_tpu_torch run {p} "
                  f"--device cuda {' '.join('--set ' + o for o in overrides[k])}",
                  flush=True)
            argv = ["run", os.path.join(ROOT, p), "--device", "cuda"]
            for o in overrides[k]:
                argv += ["--set", o]
            if cli_main(argv) != 0:
                raise AssertionError(f"{k}: the CLI returned non-zero")
            runs[k] = results[-1]
            grew = {key: cg.LAUNCHES[key] - before[key] for key in before}
            print(f"{k}: kernel launches {grew}", flush=True)
            want = "rows" if k == "c1" else "sym"
            if grew[want] <= 0:
                raise AssertionError(f"{k}: the {want} kernel never launched")
    finally:
        run_mod.run = real_run
    if any(cg.PLAIN_CALLS.values()):
        raise AssertionError(f"plain twins ran on the main path: "
                             f"{cg.PLAIN_CALLS}")
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
              f"{rate:.4e} N^2-equivalent interactions/s", flush=True)
        if not drift <= bound:
            raise AssertionError(f"{k}: max|{col}| = {drift:.3e} > {bound:g}")
    return runs


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
    print(smi.stdout.strip())
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
    run_main_path(cg, device, budget)

    kernels = []
    for key, name, src, rep, also in (
            ("rows", "rows_accel", "oc_nbody_tpu_torch/csrc/rows_accel.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:110",
             "oc_nbody_tpu/ops/pallas_gravity.py:199"),
            ("sym", "sym_accel", "oc_nbody_tpu_torch/csrc/sym_accel.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_P)")):
        err, ms, pms, shape = main_shapes[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "also_replaces": also,
                        "launches": cg.LAUNCHES[key], "max_abs_err": err,
                        "ms": ms, "plain_ms": pms, "shape": shape})
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
