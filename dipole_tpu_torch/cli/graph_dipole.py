"""CLI for the patch-graph orientation pipeline and experiment harness — the
port of dipole_tpu/cli/graph_dipole.py (reference graph_dipole.py __main__,
:342-348), with `--device` (default cuda).

    python -m dipole_tpu_torch.cli.graph_dipole run --pc x.ply --device cpu
    python -m dipole_tpu_torch.cli.graph_dipole folder --folder d/ --exp_name e
"""
from __future__ import annotations

import argparse
from functools import partial
from pathlib import Path


def get_parser():
    parser = argparse.ArgumentParser("graph_dipole")
    sub = parser.add_subparsers(dest="cmd", required=True)

    one = sub.add_parser("run", help="orient one cloud via the patch graph")
    one.add_argument("--pc", type=Path, required=True)
    one.add_argument("--ncut", action="store_true",
                     help="ncut partitioning instead of the voxel grid")
    one.add_argument("--verbose", action="store_true")
    one.add_argument("--output", type=Path, default=None)

    folder = sub.add_parser("folder", help="batch-run a folder of .ply files")
    folder.add_argument("--folder", type=Path, required=True)
    folder.add_argument("--exp_name", type=str, required=True)
    folder.add_argument("--parallel", action="store_true")
    folder.add_argument("--compare", action="store_true",
                        help="A/B compare variants against gt-named twins")
    folder.add_argument("--log_dir", type=Path, default=Path("temp"))
    for p in (one, folder):
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device: cuda (default) or cpu")
    return parser


def main(argv=None, timer=None):
    """Runs the command; `run` returns its GT metrics (or None) and fills
    `timer` (a utils.timing.timer_factory() clock) with its stage times."""
    from dipole_tpu_torch.pipelines import graph_dipole as gd

    args = get_parser().parse_args(argv)
    if args.cmd == "run":
        metrics = gd.graph_dipole(str(args.pc), use_ncut=args.ncut,
                                  verbose=args.verbose,
                                  output_path=str(args.output) if args.output else None,
                                  device=args.device, timer=timer)
        if metrics:
            print(metrics)
        return metrics
    handler = gd.run_res_and_compare if args.compare else gd.run_file
    log = gd.run_folder(args.folder, args.exp_name, if_parallel=args.parallel,
                        handler=partial(handler, device=args.device),
                        log_dir=args.log_dir)
    print(f"wrote {log}")
    return None


if __name__ == "__main__":
    main()
