"""Patch-based orientation with PointCNN ensemble correction — the port of
dipole_tpu/cli/orient_pointcloud.py (reference orient_pointcloud.py:11-83):
voxel patches -> curvature filter -> orient_center -> iterate {ensemble flip
votes, periodic patch propagation} -> final propagation -> lattice sign fix
-> export final_result.xyz and opts.txt. Thin wrapper over
`dipole_tpu_torch.api.orient_patches` (or `orient_patches_consensus` with
--consensus > 1); --device picks the torch device (default cuda).

    python -m dipole_tpu_torch.cli.orient_pointcloud --pc in.xyz \\
        --export_dir out/ --models pre_trained_tpu/dipole_0.pt [--device cpu]
"""
from __future__ import annotations

from pathlib import Path

from dipole_tpu_torch import api
from dipole_tpu_torch.utils import config
from dipole_tpu_torch.utils.io import export_pc, load_xyz
from dipole_tpu_torch.utils.timing import timer_factory
from dipole_tpu_torch.utils.warmup import ensure_warm


def run(opts):
    stage_timer = timer_factory()
    export_path = Path(opts.export_dir)
    export_path.mkdir(exist_ok=True, parents=True)

    pc = load_xyz(opts.pc)
    kw = dict(models=opts.models, iters=opts.iters,
              propagation_iters=opts.propagation_iters,
              number_parts=opts.number_parts,
              minimum_points_per_patch=opts.minimum_points_per_patch,
              curvature_threshold=opts.curvature_threshold,
              diffuse=opts.diffuse, weighted_prop=opts.weighted_prop,
              estimate=opts.estimate_normals, n=opts.n, timer=stage_timer,
              mesh=opts.mesh, torch_rng=opts.torch_rng,
              vote_starts=opts.vote_starts, fps_starts=opts.fps_starts,
              vote_margin=opts.vote_margin, fix_models=opts.fix_models,
              fix_margin=opts.fix_margin, fix_when=opts.fix_when,
              fix_vote=opts.fix_vote, device=opts.device)
    if opts.consensus <= 1:
        oriented = api.orient_patches(pc, vote_seed=opts.vote_seed, **kw)
    else:
        seeds = list(range(opts.vote_seed, opts.vote_seed + opts.consensus))
        oriented = api.orient_patches_consensus(pc, vote_seeds=seeds, **kw)

    stage_timer.print_total_time()
    export_pc(oriented, export_path / "final_result.xyz")
    return oriented


def main(argv=None):
    opts = config.get_parser().parse_args(argv)
    config.export_options(opts)
    ensure_warm(device=opts.device)  # first run on a machine with a card
    run(opts)


if __name__ == "__main__":
    main()
