"""CLI: ``python -m oc_nbody_tpu_torch run configs/c1_plummer_1k.toml``.

The JAX package's ``run`` and ``info`` commands with ``--set a.b=v``
overrides, plus ``--device cuda|cpu`` (default cuda; with no card it
raises rather than fall back). ``--resume`` and ``ensemble`` are not ported
yet and raise.
"""
from __future__ import annotations

import argparse
import sys


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

    p_info = sub.add_parser("info", help="print a resolved config")
    p_info.add_argument("config")
    p_info.add_argument("--set", dest="overrides", action="append", default=[])

    args = parser.parse_args(argv)
    if args.command == "ensemble":
        raise NotImplementedError("the ensemble command is not ported yet "
                                  "(ROADMAP A16)")

    from oc_nbody_tpu_torch.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.command == "info":
        print(cfg.to_json())
        return 0

    from oc_nbody_tpu_torch.run import run

    result = run(cfg, device=args.device, resume=args.resume)
    print(f"done: t={result.state.time:.6g} steps={result.n_steps} "
          f"wall={result.wall_time_s:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
