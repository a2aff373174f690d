"""Server-side algorithm handlers, dispatched by function_name — the port of
dipole_tpu/serve/handlers.py:35-149.

Parity with the reference's handler set (socket_server.py:18-60,
socket_server_para.py:70-135): simple_estimate, hoppe_estimate,
graph_dipole_estimate, xie_propagation, tree_xie_propagation. Degenerate
inputs (< max_nn points) short-circuit with placeholder normals like the
reference's warning path (socket_server_para.py:70-75). Every handler takes
`device` (default "cuda"). With a `batcher` (serve/batching.MicroBatcher,
the threaded server's), simple_estimate and tree_xie_propagation without a
kNN mask run their device stages micro-batched with concurrent requests.
The server mesh comes with the multi-device slice: a mesh above one device
raises.
"""
from __future__ import annotations

import numpy as np

from dipole_tpu_torch import graphs
from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.ops import fields, propagate
from dipole_tpu_torch.ops.estimate import estimate_normals
from dipole_tpu_torch.utils.io import Transform

__all__ = ["HANDLERS", "dispatch", "set_mesh", "get_mesh"]


def set_mesh(mesh) -> None:
    """The server-wide mesh: one device only (a count above 1 raises,
    naming the multi-device slice)."""
    from dipole_tpu_torch.api import resolve_mesh

    resolve_mesh(mesh)


def get_mesh():
    return None


def _prep(xyz_data: np.ndarray, max_nn: int, dev):
    pc = np.asarray(xyz_data, dtype=np.float32)
    pc = estimate_normals(pc, max_nn=max_nn, device=dev)
    return Transform.trans(pc)


def _finish(pc: np.ndarray, transform: Transform, dev) -> np.ndarray:
    if fields.measure_mean_potential(pc, device=dev) < 0:
        pc[:, 3:6] *= -1
    return transform.inverse(pc).astype(np.float64)


def simple_estimate(xyz_data, config, device="cuda"):
    dev = resolve_device(device)
    pc, transform = _prep(xyz_data, 30, dev)
    pc = propagate.strongest_field_propagation_points(
        pc, diffuse=config.get("diffuse", True), starting_point=0, device=dev)
    return _finish(pc, transform, dev)


def xie_propagation(xyz_data, config, device="cuda"):
    dev = resolve_device(device)
    pc, transform = _prep(xyz_data, config["max_nn"], dev)
    pc = propagate.xie_propagation_points(
        pc, eps=config["eps"], diffuse=config["diffuse"], starting_point=0,
        device=dev)
    return _finish(pc, transform, dev)


def tree_xie_propagation(xyz_data, config, device="cuda"):
    dev = resolve_device(device)
    pc, transform = _prep(xyz_data, config["max_nn"], dev)
    pc, _ = propagate.xie_propagation_bfs_tree(
        pc, eps=config["eps"], diffuse=config["diffuse"],
        times=config["times"], starting_point=0,
        knn_mask=config.get("knn_mask", -1), C=config.get("C", 3), device=dev)
    return _finish(pc, transform, dev)


def hoppe_estimate(xyz_data, config, device="cuda"):
    dev = resolve_device(device)
    pc = np.asarray(xyz_data, dtype=np.float32)
    pc = estimate_normals(pc, max_nn=config.get("k_neighbor", 10),
                          radius=config.get("r", 0.1), device=dev)
    pc = graphs.orient_normals_hoppe(pc, k=config.get("k_neighbor", 10))
    return pc.astype(np.float64)


def graph_dipole_estimate(xyz_data, config, device="cuda"):
    from dipole_tpu_torch.pipelines.graph_dipole import graph_dipole_server_api

    return graph_dipole_server_api(xyz_data, config,
                                   device=device).astype(np.float64)


HANDLERS = {
    "simple_estimate": simple_estimate,
    "hoppe_estimate": hoppe_estimate,
    "graph_dipole_estimate": graph_dipole_estimate,
    "xie_propagation": xie_propagation,
    "tree_xie_propagation": tree_xie_propagation,
}


def dispatch(function_name: str, xyz_data: np.ndarray, config: dict,
             log=None, batcher=None, device="cuda") -> np.ndarray:
    if function_name not in HANDLERS:
        raise ValueError(f"Unknown method: {function_name}")
    max_nn = config.get("max_nn", 30)
    if function_name != "hoppe_estimate" and len(xyz_data) < max_nn:
        if log is not None:
            log(
                f"cloud too small for normal estimation ({len(xyz_data)} "
                f"points < max_nn={max_nn}); returning placeholder normals",
                mode="warning",
            )
        out = np.ones((len(xyz_data), 6))
        out[:, :3] = xyz_data
        return out
    if batcher is not None and function_name == "simple_estimate":
        from dipole_tpu_torch.serve.batching import batched_simple_estimate

        return batched_simple_estimate(batcher, xyz_data, config, device=device)
    if batcher is not None and function_name == "tree_xie_propagation" \
            and config.get("knn_mask", -1) <= 0:
        from dipole_tpu_torch.serve.batching import batched_tree_xie

        return batched_tree_xie(batcher, xyz_data, config, device=device)
    return HANDLERS[function_name](xyz_data, config, device=device)
