"""PointCNN checkpoints: the `.pt` state_dicts of `pre_trained_tpu/` and
their `.txt` sidecars — the port of dipole_tpu/models/checkpoints.py:89-118.

The JAX package reads the zip+pickle format with a restricted unpickler of
its own; the port has torch, whose `torch.load(..., weights_only=True)` is
the same kind of restricted reader (tensors and containers only, no code).
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

__all__ = ["load_state_dict", "load_model_opts"]


def load_state_dict(path) -> "OrderedDict[str, np.ndarray]":
    """A zip-format .pt state_dict as an OrderedDict of numpy arrays."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(obj)}")
    return OrderedDict((k, v.numpy()) for k, v in obj.items())


def load_model_opts(path) -> dict:
    """Parse the sidecar .txt hyperparameter file (only key: pool) —
    reference inference_utils.txt2opts (:19-35)."""
    opts = {}
    for line in Path(path).read_text().split("\n"):
        line = line.replace(" ", "")
        if not line:
            continue
        tokens = line.split(":")
        if tokens[0] == "pool":
            opts["pool"] = float(tokens[1])
    return opts
