"""The readings the limits of ``correct`` are set from: for each seed, one
segment of the cell through the timed path, then the compared numbers of
the program (the lower readings) and of the control, the reference in
bfloat16 put in the program's place (the upper readings). With
``--fault-seeds``, those seeds then run with the stepper kind's fault
(``Kind.fault``, ``faults.py``) planted (the upper readings of ``drift``, which the control,
giving answers and no trajectory, has none of).

    python3 bench_torch/readings.py --workload <cell> --seeds 11 12 ... \
        [--fault-seeds 21 22 23]

Runs on the cards the cell asks for; the benchmark's own runs do not run
it. ``--n`` (with the CPU) is for the tests.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def segment_readings(cell, seed: int, device: str = "cuda", n=None,
                     mesh=None, control: bool = True) -> dict:
    """{'program': numbers, 'control': numbers} of one segment of ``cell``
    from the seed's set-up carry (without ``control``, no 'control')."""
    import torch
    from bench_torch import check, harness
    from oc_nbody_tpu_torch import diagnostics as diag_mod
    from oc_nbody_tpu_torch import run as run_mod
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    cfg = harness.sim_config(cell, seed, n)
    scene = build_scene(cfg, device, mesh=mesh)
    stepper, kind = make_stepper(cfg, scene.force)
    carry0 = stepper.init(scene.state)
    end = stepper.advance_to(carry0, scene.state.time + cell.segment)
    o = cfg.output
    row = run_mod._to_host(diag_mod.compute_all(
        end.state, scene.force, o.fractions, f64_pairwise=o.diag_f64,
        core=o.core_diag))
    start = carry0.state
    t = end.state.time - start.time
    del stepper, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    phys = check.Physics.of(cell.sim)
    out = {"steps": end.n_steps,
           "program": check.readings(kind, phys, start, end, row, t)}
    if control:
        out["control"] = check.readings(kind, phys, start, end, row, t,
                                        control=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_torch import harness, kinds
    cell = harness.load_cell(args.workload, harness.load_benchmark(ROOT))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        r = segment_readings(cell, seed)
        r["seed"] = seed
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.fault_seeds:
        kind = cell.sim["integrator"]["kind"]
        kinds.of(kind).fault(setattr)
        for seed in args.fault_seeds:
            r = segment_readings(cell, seed, control=False)
            r["seed"], r["fault"] = seed, kind
            rows.append(r)
            print(json.dumps(r), flush=True)
    sound = [r for r in rows if "fault" not in r]
    faulty = [r for r in rows if "fault" in r]
    for label, side, group in (("program", "program", sound),
                               ("control", "control", sound),
                               ("fault", "program", faulty)):
        if not group:
            continue
        names = group[0][side]
        print(f"{cell.name} {label} over {len(group)} seeds: " + ", ".join(
            f"{k} {min(r[side][k] for r in group):.4g}.."
            f"{max(r[side][k] for r in group):.4g}" for k in names),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
