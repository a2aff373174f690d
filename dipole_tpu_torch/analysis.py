"""Experiment result loading for the analysis workflows — the port of
dipole_tpu/analysis.py.

Parity with reference analysis.py:7-30 (the support module for
ana_patch.ipynb): loads per-segment .ply results + their metrics from a
reslog.json, and exposes the self-interaction energy diagnostics
(fields.self_interaction*, csrc/field.cu on the card) used to correlate
dipole self-energy with ground-truth error."""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from dipole_tpu_torch.ops import fields
from dipole_tpu_torch.utils.io import Transform, load_point_cloud

__all__ = ["Segment", "get_segs", "self_interaction_table"]


class Segment:
    """One segment result: normalized cloud + its logged metric."""

    def __init__(self, folder, seg_id: int, seg_type: str, log):
        self.id = seg_id
        path = Path(folder) / f"{seg_type}{seg_id}.ply"
        data = load_point_cloud(path)
        self.nxyz, self.trans = Transform.trans(data)
        entries = [x for x in log if x.get("id") == seg_id]
        self.metric = entries[0]["metric"] if entries else None


def get_segs(folder, seg_type: str = "res"):
    """Load all '<seg_type><i>.ply' segments with metrics from
    '<folder>/reslog.json' (reference analysis.get_segs)."""
    folder = Path(folder)
    with open(folder / "reslog.json") as f:
        log = json.load(f)["node_log"]
    files = [f for f in os.listdir(folder)
             if seg_type in f and f.endswith(".ply")]
    segs = [Segment(folder, i, seg_type, log) for i in range(len(files))]
    return [s for s in segs if s.metric is not None]


def self_interaction_table(segs, rng=None, device="cuda"):
    """Per-segment dipole self-energy diagnostics (reference ana_patch.ipynb
    workflow): (id, metric, self_interaction, self_interaction_all,
    random baseline), the fields on `device`."""
    rng = rng or np.random.default_rng(0)
    rows = []
    for s in segs:
        rows.append({
            "id": s.id,
            "metric": s.metric,
            "self_interaction": fields.self_interaction(s.nxyz, rng=rng,
                                                        device=device),
            "self_interaction_all": fields.self_interaction_all(s.nxyz,
                                                                device=device),
            "random_self_interaction": fields.random_self_interaction(
                s.nxyz, rng=rng, device=device),
        })
    return rows
