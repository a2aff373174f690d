"""Large-cloud orientation through representative points — the port of
dipole_tpu/cli/orient_large.py (reference orient_large.py:10-90): normalize
-> optional normal estimation -> voxel patches -> curvature filter ->
orient_center -> <= 500 random representatives per patch -> PointCNN
ensemble on the representatives -> representative propagation (diffuse),
rest points by the representatives' field -> lattice sign fix -> export
final_result.xyz and opts.txt. Thin wrapper over
`dipole_tpu_torch.api.orient_large`; --device picks the torch device
(default cuda).

    python -m dipole_tpu_torch.cli.orient_large --pc in.xyz --export_dir out/ \\
        --models pre_trained_tpu/dipole_0.pt [--device cpu]
"""
from __future__ import annotations

from pathlib import Path

from dipole_tpu_torch import api
from dipole_tpu_torch.utils import config
from dipole_tpu_torch.utils.io import export_pc, load_xyz
from dipole_tpu_torch.utils.timing import timer_factory
from dipole_tpu_torch.utils.warmup import ensure_warm

MAX_PATCH_SIZE = api.MAX_PATCH_SIZE  # reference orient_large.py:14


def run(opts):
    stage_timer = timer_factory()
    export_path = Path(opts.export_dir)
    export_path.mkdir(exist_ok=True, parents=True)

    with stage_timer("load point cloud", count=False):
        input_pc = load_xyz(opts.pc, append_normals=False)
    print(input_pc.shape)

    oriented = api.orient_large(
        input_pc, models=opts.models, iters=opts.iters,
        number_parts=opts.number_parts,
        minimum_points_per_patch=opts.minimum_points_per_patch,
        curvature_threshold=opts.curvature_threshold,
        estimate=opts.estimate_normals, n=opts.n, timer=stage_timer,
        mesh=getattr(opts, "mesh", None),
        vote_starts=getattr(opts, "vote_starts", 1),
        fps_starts=getattr(opts, "fps_starts", "rng"),
        vote_margin=getattr(opts, "vote_margin", 0.0),
        fix_models=getattr(opts, "fix_models", ()),
        fix_margin=getattr(opts, "fix_margin", 0.25),
        fix_when=getattr(opts, "fix_when", "last"),
        fix_vote=getattr(opts, "fix_vote", "all"),
        vote_seed=getattr(opts, "vote_seed", 1), device=opts.device)

    with stage_timer("export oriented cloud", count=False):
        export_pc(oriented, export_path / "final_result.xyz")

    stage_timer.print_total_time()
    return oriented


def main(argv=None):
    opts = config.get_parser().parse_args(argv)
    config.export_options(opts)
    ensure_warm(device=opts.device)  # first run on a machine with a card
    run(opts)


if __name__ == "__main__":
    main()
