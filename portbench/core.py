"""What every cell shares: finding its parts by name, the card's identity,
the import check and the result line.

A cell of BENCHMARK.json names a configuration (its `file`, a JSON object
whose `entries` name, for each traffic kind, the module of entries/ that
calls the program) and a traffic mix (traffic/<name>.json, whose `kind` is
the module of loops/ that drives it). cells/<cell>.json holds the limits
that decide `correct`, and metrics/<name>.py each per-layer metric's reader
(see `metric_reader`). A new cell, configuration, mix or metric is new
files and new entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dipole_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    limits and metric entries, found by name under `root`."""

    def __init__(self, name: str, root: Path = ROOT, spec: dict | None = None):
        spec = load_spec(root) if spec is None else spec
        self.root = root
        self.name = name
        self.workload = _by_name(spec["workloads"], name, "workload")
        self.config_entry = _by_name(spec["configs"], self.workload["config"],
                                     "configuration")
        self.config = read_json(root / self.config_entry["file"])
        self.traffic = read_json(root / "portbench" / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = read_json(root / "portbench" / "cells" / f"{name}.json")["limits"]
        self.chips = int(self.workload["chips"])
        self.run_seconds = spec["run_seconds"]
        self.end_to_end = [m for m in spec["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _reports(m, name)]

    def entry(self):
        name = self.config["entries"][self.traffic["kind"]]
        return importlib.import_module(f"portbench.entries.{name}")

    def loop(self):
        return importlib.import_module(f"portbench.loops.{self.traffic['kind']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` of metrics/<name>.py (a file name may hold dots), or
    else of metrics/<quantity>.py for a name <quantity>.<suffix>: one
    quantity split by the end-to-end metric that its cells move
    (idle_share.batch, idle_share.serve) keeps one reader."""
    folder = root / "portbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, ctx) -> dict:
    """{name: {"value", "unit"}} of each entry whose reader found something
    to read (a reader that finds nothing returns None and is left out)."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"], ctx.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN_MODULES, compared whole: dipole_tpu_torch is not dipole_tpu."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN_MODULES})


def card(device_count: int) -> dict:
    """The card's name and power limit as nvidia-smi reads them (None where
    it cannot be read), for the result line."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": device_count, "power_limit_w": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split("\n")[0].strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return info


def judge(numbers: dict, limits: dict) -> bool:
    """True when every compared number is within its limit (a number that is
    missing or not finite fails)."""
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or not (value <= limit):
            ok = False
    return ok


def check_lines(numbers: dict, limits: dict) -> list:
    return [f"check {name} {numbers.get(name)!r} limit {limits[name]!r}"
            for name in limits]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, numbers: dict, limits: dict,
                breakdown: dict | None = None) -> str:
    """The run's last stdout line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": _finite(numbers.get(name)), "limit": limits[name]}
                     for name in limits}
    return json.dumps(out, allow_nan=False)


def _finite(value):
    """A compared number as JSON can hold it: None where it is missing or
    not finite (a missing answer), which fails its limit."""
    return value if value is not None and math.isfinite(value) else None
