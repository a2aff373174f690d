"""PointCNN checkpoints: the `.pt` state_dicts of `pre_trained_tpu/` and
their `.txt` sidecars — the port of dipole_tpu/models/checkpoints.py:89-118
(reader) and :194-256 (writer).

The JAX package reads and writes the zip+pickle format with a restricted
unpickler and a pickle emitter of its own; the port has torch, whose
`torch.load(..., weights_only=True)` is the same kind of restricted reader
(tensors and containers only, no code) and whose `torch.save` writes the
format the JAX package's reader takes (tests/test_torch_checkpoints.py holds
both readers to a round trip).
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

__all__ = ["load_state_dict", "save_state_dict", "load_model_opts"]


def load_state_dict(path) -> "OrderedDict[str, np.ndarray]":
    """A zip-format .pt state_dict as an OrderedDict of numpy arrays."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(obj)}")
    return OrderedDict((k, v.numpy()) for k, v in obj.items())


def save_state_dict(state_dict, path) -> None:
    """Write a state_dict (numpy arrays or tensors, keys in their order) as
    a zip-format .pt: each value a contiguous CPU tensor of its own
    storage, so it loads with torch.load, load_state_dict here and the JAX
    package's reader."""
    out = OrderedDict()
    for k, v in state_dict.items():
        t = (v.detach().to("cpu").clone() if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v)))
        out[k] = t.contiguous()
    torch.save(out, Path(path))


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
