"""Programmatic API facade — the port of dipole_tpu/cli/dipole_api.py
(reference dipole_api.py:14-136): orient_large with api-flavoured defaults
(estimate_normals on, the v1 checkpoints pre_trained_tpu/dipole_{0,1,2}.pt
preloaded, nothing required), plus --device. Writes final_result.xyz and
opts.txt. orient_large_np is the in-memory entry with the same defaults.

    python -m dipole_tpu_torch.cli.dipole_api --pc in.xyz --export_dir out/
"""
from __future__ import annotations

import argparse
from pathlib import Path

from dipole_tpu_torch.cli import orient_large as _orient_large
from dipole_tpu_torch.utils import config
from dipole_tpu_torch.utils.warmup import ensure_warm

DEFAULT_MODELS = [Path(__file__).resolve().parents[2] / "pre_trained_tpu"
                  / f"dipole_{i}.pt" for i in range(3)]


def orient_large(opts):
    """Run the representative-point pipeline (reference dipole_api.py:14-87)."""
    return _orient_large.run(opts)


def orient_large_np(points, models=None, device="cuda", **kwargs):
    """Orient an (N, 3|6) array in memory; returns the oriented (N, 6) array
    (JAX cli/dipole_api.py:26-43): api.orient_large with this module's
    defaults (DEFAULT_MODELS, iters 5, number_parts 10,
    minimum_points_per_patch 100, curvature_threshold 0, estimate_normals
    on, n 30). It reads those six keyword arguments and, as the JAX
    wrapper, ignores any other."""
    from dipole_tpu_torch import api

    return api.orient_large(
        points, models=models or DEFAULT_MODELS,
        iters=kwargs.pop("iters", 5),
        number_parts=kwargs.pop("number_parts", 10),
        minimum_points_per_patch=kwargs.pop("minimum_points_per_patch", 100),
        curvature_threshold=kwargs.pop("curvature_threshold", 0.0),
        estimate=kwargs.pop("estimate_normals", True),
        n=kwargs.pop("n", 30), device=device)


def get_parser():
    """API-flavoured parser (reference dipole_api.py:101-132): the base
    flags with api defaults and nothing required, plus --device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--pc", type=Path, default=None, help="path to the point cloud")
    parser.add_argument("--models", type=Path, nargs="+", default=DEFAULT_MODELS)
    parser.add_argument("--export_dir", type=Path, default=Path("output"))
    parser.add_argument("--number_parts", type=int, default=10)
    parser.add_argument("--minimum_points_per_patch", type=int, default=100)
    parser.add_argument("--curvature_threshold", type=float, default=0.0)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--diffuse", default=True, action="store_true")
    parser.add_argument("--weighted_prop", default=True, action="store_true")
    parser.add_argument("--estimate_normals", default=True, action="store_true")
    parser.add_argument("--n", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises without "
                             "a GPU) or 'cpu'")
    return parser


def main(argv=None):
    opts = get_parser().parse_args(argv)
    if opts.pc is None:
        raise SystemExit("dipole_api: --pc is required to run")
    config.export_options(opts)
    ensure_warm(device=opts.device)  # first run on a machine with a card
    orient_large(opts)


if __name__ == "__main__":
    main()
