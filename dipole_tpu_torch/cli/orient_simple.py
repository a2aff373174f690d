"""Per-point dipole propagation CLI — the port of
dipole_tpu/cli/orient_simple.py (reference orient_simple.py:8-43):
load -> (optional) estimate normals -> normalize -> strongest-field
propagation -> lattice-potential global sign fix -> denormalize -> export
final_result.xyz and opts.txt. Thin wrapper over
`dipole_tpu_torch.api.orient_simple`; --device picks the torch device
(default cuda).

    python -m dipole_tpu_torch.cli.orient_simple --pc in.xyz \
        --export_dir out/ [--diffuse] [--estimate_normals] [--device cpu]
"""
from __future__ import annotations

from pathlib import Path

from dipole_tpu_torch import api
from dipole_tpu_torch.utils import config
from dipole_tpu_torch.utils.io import export_pc, load_xyz
from dipole_tpu_torch.utils.timing import timer_factory
from dipole_tpu_torch.utils.warmup import ensure_warm


def run(opts):
    export_path = Path(opts.export_dir)
    export_path.mkdir(exist_ok=True, parents=True)
    stage_timer = timer_factory()

    with stage_timer("load point cloud", count=False):
        input_pc = load_xyz(opts.pc)

    # reference orient_simple.py:19 pins max_nn=30 (not opts.n)
    oriented = api.orient_simple(input_pc, diffuse=opts.diffuse,
                                 estimate=opts.estimate_normals, n=30,
                                 timer=stage_timer,
                                 mesh=getattr(opts, "mesh", None),
                                 device=opts.device)

    with stage_timer("export oriented cloud", count=False):
        export_pc(oriented, export_path / "final_result.xyz")

    stage_timer.print_total_time()
    return oriented


def main(argv=None):
    opts = config.get_parser().parse_args(argv)
    opts.export_dir.mkdir(exist_ok=True, parents=True)
    config.export_options(opts)
    ensure_warm(device=opts.device)  # first run on a machine with a card
    run(opts)


if __name__ == "__main__":
    main()
