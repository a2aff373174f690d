"""CLI flag system — the JAX package's flags, defaults and opts.txt dump
(dipole_tpu/utils/config.py, reference options.py:5-32), plus --device.

--device is the counterpart of JAX_PLATFORMS: "cuda" (the default) or "cpu".
--mesh is parsed as in the JAX package and reaches the API's `mesh`: a
device count (the first N cards; with --device cpu, N CPU shards) or 'auto'
(api.resolve_mesh). PipelineOptions is the JAX package's dataclass view of
the defaults, field for field."""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["get_parser", "export_options", "PipelineOptions"]


def get_parser(name: str = "Base Options") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(name)
    parser.add_argument("--export_dir", type=Path, required=True, help="export directory")
    parser.add_argument("--propagation_iters", default=10, type=int, help="test epochs")
    parser.add_argument("--number_parts", type=int, default=15)
    parser.add_argument("--minimum_points_per_patch", type=int, default=21)
    parser.add_argument("--curvature_threshold", default=0.0, type=float)
    parser.add_argument("--pc", type=Path, required=True, help="pc to read")
    parser.add_argument("--models", nargs="+", type=Path, default=[],
                        help="path to trained models")
    parser.add_argument("--iters", default=100, type=int, help="iters to optimize")
    parser.add_argument("--diffuse", action="store_true")
    parser.add_argument("--weighted_prop", action="store_true")
    parser.add_argument("--estimate_normals", action="store_true")
    parser.add_argument("--n", type=int, default=30,
                        help="size of knn for normal estimation")
    parser.add_argument("--mesh", default=os.environ.get("DIPOLE_TPU_MESH"),
                        help="multi-device: device count or 'auto' "
                             "(default: DIPOLE_TPU_MESH env; unset = 1 device)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises without "
                             "a GPU) or 'cpu'")
    parser.add_argument("--torch_rng", type=int, default=None,
                        help="replay the torch reference's FPS-start RNG "
                             "bit-exactly from this seed (reference pins "
                             "torch.manual_seed(1))")
    parser.add_argument("--fps_starts", choices=("rng", "centroid"),
                        default="rng",
                        help="FPS start policy for the ensemble forwards: "
                             "'rng' = one random start per model per patch "
                             "(reference semantics); 'centroid' = "
                             "deterministic patch-centroid-nearest start "
                             "(no start noise)")
    parser.add_argument("--vote_starts", type=_vote_starts, default=1,
                        help="FPS-start ensembling: votes per model per "
                             "patch (1 = reference semantics; >1 averages "
                             "out FPS-start noise at vote_starts x forward "
                             "cost — measured strictly WORSE end-to-end; a "
                             "warning is emitted)")
    parser.add_argument("--vote_margin", type=float, default=0.0,
                        help="flip a point only when the ensemble's mean "
                             "P(flip) clears 0.5 by this margin (0 = "
                             "reference vote; >0 suppresses low-confidence "
                             "flips, trading vote recall for precision)")
    parser.add_argument("--fix_models", nargs="+", type=Path, default=[],
                        help="staged vote: checkpoints for a per-point fix "
                             "pass run after each --models gauge vote; "
                             "flips only margin-clearing strict-minority "
                             "point sets")
    parser.add_argument("--fix_margin", type=float, default=0.25,
                        help="confidence margin for the --fix_models pass "
                             "(flip where P(flip) < 0.5 - fix_margin)")
    parser.add_argument("--fix_when", choices=("last", "every"),
                        default="last",
                        help="'last' = one fix pass after the vote loop "
                             "(measured best: false flips cannot compound); "
                             "'every' = fix pass each iteration")
    parser.add_argument("--fix_vote", choices=("all", "mean"),
                        default="all",
                        help="'all' = flip only points every fixer clears "
                             "the margin on (precision); 'mean' = "
                             "reference-style mean probability")
    parser.add_argument("--consensus", type=int, default=1,
                        help="run the patch pipeline this many times with "
                             "decorrelated vote streams and majority-vote "
                             "each point's final sign (odd; 1 = one "
                             "reference-semantics run)")
    parser.add_argument("--vote_seed", type=int, default=1,
                        help="base PRNG seed of the ensemble vote stream "
                             "(1 = the reference's pinned seed)")
    return parser


def _vote_starts(value: str) -> int:
    """argparse type for --vote_starts: values above 1 warn at parse time
    (the JAX package measured start averaging worse end to end)."""
    s = int(value)
    if s > 1:
        import warnings

        warnings.warn(
            f"--vote_starts {s}: start-vote averaging was measured strictly "
            "worse end-to-end by the JAX package. Prefer more models "
            "(--models) over more starts.", stacklevel=2)
    return s


def export_options(opts) -> None:
    d = opts.__dict__ if hasattr(opts, "__dict__") else dict(opts)
    txt = "\n".join(f"{k}: {v}" for k, v in d.items())
    Path(opts.export_dir).mkdir(parents=True, exist_ok=True)
    (Path(opts.export_dir) / "opts.txt").write_text(txt)


@dataclass
class PipelineOptions:
    """Programmatic options mirroring the CLI defaults (JAX
    utils/config.py:109-135, field for field)."""

    pc: Path | str = ""
    export_dir: Path | str = ""
    models: list = field(default_factory=list)
    iters: int = 100
    propagation_iters: int = 10
    number_parts: int = 15
    minimum_points_per_patch: int = 21
    curvature_threshold: float = 0.0
    diffuse: bool = False
    weighted_prop: bool = False
    estimate_normals: bool = False
    n: int = 30
    mesh: object = None
    vote_starts: int = 1
    fps_starts: str = "rng"
    vote_margin: float = 0.0
    fix_models: list = field(default_factory=list)
    fix_margin: float = 0.25
    fix_when: str = "last"
    fix_vote: str = "all"
    consensus: int = 1
    vote_seed: int = 1
