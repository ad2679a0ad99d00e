"""CLI: ``python -m oc_nbody_tpu_torch run configs/c1_plummer_1k.toml``.

The JAX package's ``run`` and ``info`` commands with ``--set a.b=v``
overrides, plus ``--device cuda|cpu`` (default cuda; with no card it
raises rather than fall back). ``info`` also prints the stepper the config
builds, the mesh ``mesh.n_devices`` resolves to here (its shards,
devices and mode; on a mesh of more than one shard the sharded force's
kernels), at the f32 and the extended tier the kernels it runs on the card
at the config's N (under escape pruning also the two sweeps' kernels at
the smallest and the largest cluster bucket), and its pairwise precision
tier; a config the port does
not run yet is reported as such (NotImplementedError from
``check_supported``).
``--resume`` and ``ensemble`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import sys


def _print_pruned_route(cfg, n, kind, precision):
    """The pruned evaluation's kernels at the smallest and the largest
    cluster bucket this config can build."""
    from oc_nbody_tpu_torch.ops import cuda_gravity
    smallest = max(int(cfg.escape.min_bucket), 1)
    largest = 1
    while 4 * largest < n:        # the largest power of two B with 2B < N
        largest *= 2
    print("escape pruning: the cluster bucket B is the next power of two at "
          "or above the cluster's size, at least min_bucket = "
          f"{cfg.escape.min_bucket}, and under N/2 (B <= {largest}); while "
          "the cluster is larger, the unpruned route runs")
    for b in sorted({smallest, largest}):
        if 2 * b < n:
            print(f"  pruned at B = {b}: "
                  f"{cuda_gravity.route_pruned(n, b, kind, precision)}")


def _print_mesh(cfg, n, kind):
    """The mesh ``mesh.n_devices`` resolves to on this machine (its cards,
    else the CPU) and, past one shard, the sharded force's kernels.
    Returns True when the run would shard."""
    import torch
    from oc_nbody_tpu_torch.parallel import force as pforce
    from oc_nbody_tpu_torch.scene import mesh_mode, resolve_mesh
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    try:
        mesh = resolve_mesh(cfg, device)
    except ValueError as err:
        print(f"mesh: mesh.n_devices = {cfg.mesh.n_devices}: {err}, so a "
              "run here raises")
        return False
    if mesh is None:
        print(f"mesh: one device ({device.type}; mesh.n_devices = "
              f"{cfg.mesh.n_devices}), the unsharded force")
        return False
    mode = mesh_mode(cfg)
    print(f"mesh: {mesh.describe()}, mode {mode}; kernels per force "
          f"evaluation at N = {n}: "
          f"{pforce.route(n, mesh.n_devices, mode, kind)}")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(prog="oc_nbody_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run a simulation from a config file")
    p_run.add_argument("config", help="TOML or JSON config path")
    p_run.add_argument("--set", dest="overrides", action="append", default=[],
                       metavar="a.b=v", help="override a config value")
    p_run.add_argument("--resume", action="store_true",
                       help="resume from the latest snapshot (not ported "
                            "yet: raises)")
    p_run.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the state and the force kernels run "
                            "(cpu runs the kernels' plain PyTorch twins)")

    p_ens = sub.add_parser("ensemble", help="not ported yet (raises)")
    p_ens.add_argument("config")
    p_ens.add_argument("rest", nargs=argparse.REMAINDER)

    p_info = sub.add_parser("info", help="print a resolved config and the "
                                         "stepper it builds")
    p_info.add_argument("config")
    p_info.add_argument("--set", dest="overrides", action="append", default=[])

    args = parser.parse_args(argv)
    if args.command == "ensemble":
        raise NotImplementedError("the ensemble command is not ported yet "
                                  "(ROADMAP A16)")

    from oc_nbody_tpu_torch.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.command == "info":
        from oc_nbody_tpu_torch.forces import make_force_model
        from oc_nbody_tpu_torch.ops import cuda_gravity
        from oc_nbody_tpu_torch.scene import (build_units, check_supported,
                                              make_stepper, n_particles)
        print(cfg.to_json())
        try:
            check_supported(cfg)
        except NotImplementedError as err:
            print(f"stepper: none, the config does not run here: {err}")
            return 0
        force = make_force_model(cfg.integrator.eps, build_units(cfg).G,
                                 precision=cfg.integrator.precision)
        stepper, kind = make_stepper(cfg, force)
        fields = {k: v for k, v in vars(stepper).items()
                  if k != "force" and not k.startswith("_")}
        print(f"stepper: {kind} {type(stepper).__name__}({fields})")
        n = n_particles(cfg)
        sharded = _print_mesh(cfg, n, kind)
        if force.precision in ("f32", "extended") and not sharded:
            print(f"kernels on the card at N = {n}: "
                  f"{cuda_gravity.route(n, kind, force.precision)}")
            if cfg.escape.prune:
                _print_pruned_route(cfg, n, kind, force.precision)
        print(f"pairwise precision tier: {force.precision}; diagnostics "
              f"potential: {'f64' if cfg.output.diag_f64 else 'the tier'}")
        return 0

    from oc_nbody_tpu_torch.run import run

    result = run(cfg, device=args.device, resume=args.resume)
    d = result.diagnostics
    drift = max(abs(float(x)) for x in d["dE_over_E_int"])
    cons = (f" max|dE_cons/E_int|="
            f"{max(abs(float(x)) for x in d['dE_cons_over_E_int']):.3e}"
            if "dE_cons_over_E_int" in d else "")
    per_step = result.phase_s.get("advance", 0.0) / max(1, result.n_steps)
    print(f"done: t={result.state.time:.6g} steps={result.n_steps} "
          f"wall={result.wall_time_s:.1f}s max|dE/E_int|={drift:.3e}{cons} "
          f"advance={per_step:.6g} s/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
