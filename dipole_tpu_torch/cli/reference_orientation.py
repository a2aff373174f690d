"""Orientation transfer from an oriented reference cloud — the port of
dipole_tpu/cli/reference_orientation.py (reference
reference_orientation.py:8-41): one dense dipole field evaluation of the
reference cloud at the input points; inputs without normals adopt the
normalized field, inputs with normals only take its sign. No normalization
and no global sign fix. Writes --output and, beside it, opts.txt; --device
picks the torch device (default cuda).

    python -m dipole_tpu_torch.cli.reference_orientation --input in.xyz \\
        --reference oriented.xyz --output out/final_result.xyz
"""
from __future__ import annotations

import argparse
from pathlib import Path

from dipole_tpu_torch.api import transfer_orientation
from dipole_tpu_torch.utils import config
from dipole_tpu_torch.utils.io import export_pc, load_xyz
from dipole_tpu_torch.utils.timing import timer_factory
from dipole_tpu_torch.utils.warmup import ensure_warm


def run(opts):
    stage_timer = timer_factory()
    with stage_timer("load input cloud", count=False):
        input_pc = load_xyz(opts.input, append_normals=False)
    with stage_timer("load reference cloud", count=False):
        ref_pc = load_xyz(opts.reference)

    with stage_timer("evaluate reference field"):
        input_pc = transfer_orientation(
            ref_pc, input_pc, n=opts.n, device=opts.device,
            estimate=input_pc.shape[-1] == 3 and opts.estimate_normals)

    with stage_timer("export transferred normals", count=False):
        export_pc(input_pc, opts.output)

    stage_timer.print_total_time()
    return input_pc


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=Path, required=True)
    parser.add_argument("--reference", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--n", type=int, default=30,
                        help="neighborhood size for PCA normal estimation")
    parser.add_argument("--estimate_normals", action="store_true",
                        help="compute unoriented PCA normals on the input "
                             "first; without this flag the reference field "
                             "supplies both the direction and the sign")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises without "
                             "a GPU) or 'cpu'")
    return parser


def main(argv=None):
    opts = get_parser().parse_args(argv)
    opts.export_dir = opts.output.parent
    config.export_options(opts)
    ensure_warm(device=opts.device)  # first run on a machine with a card
    run(opts)


if __name__ == "__main__":
    main()
