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
The server-wide mesh (set_mesh, --mesh) shards every request's device work
as api.stage_mesh decides; under a mesh the micro-batcher is bypassed for
the stages that shard. `dispatch(..., mesh=)` runs one call under another
mesh.
"""
from __future__ import annotations

import numpy as np

from dipole_tpu_torch import graphs
from dipole_tpu_torch.api import _mesh_for, resolve_mesh, stage_mesh
from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.ops import fields, propagate
from dipole_tpu_torch.ops.estimate import estimate_normals
from dipole_tpu_torch.utils.io import Transform, gen_grid
from dipole_tpu_torch.utils.timing import span

__all__ = ["HANDLERS", "dispatch", "set_mesh", "get_mesh"]


# the server-wide mesh (None: one device), set once at server start
_MESH = None


def set_mesh(mesh, device="cuda") -> None:
    """Set the server-wide mesh: a Mesh, a device count or 'auto'
    (api.resolve_mesh on `device`; a count above the cards there raises
    ValueError). None, 1 or 'off' mean one device."""
    global _MESH
    _MESH = resolve_mesh(mesh, device)


def get_mesh():
    return _MESH


def _mesh(mesh, dev):
    """The mesh a call runs under: `mesh` if given, else the server's;
    its devices must be of dev's type."""
    return _mesh_for(_MESH if mesh is None else mesh, dev)


def _prep(xyz_data: np.ndarray, max_nn: int, dev):
    """A request's host stage, the `serve.estimate` span: normals (the
    neighbour search and the PCA on `dev`; ops/estimate.py) and the
    transform into the unit box."""
    with span("serve.estimate"):
        pc = np.asarray(xyz_data, dtype=np.float32)
        pc = estimate_normals(pc, max_nn=max_nn, device=dev)
        return Transform.trans(pc)


def _unprep(pc: np.ndarray, transform: Transform) -> np.ndarray:
    """The request's way back out of the unit box, the `transform.inverse`
    span, after its propagation (batched or not)."""
    with span("transform.inverse"):
        return transform.inverse(pc).astype(np.float64)


def _finish(pc: np.ndarray, transform: Transform, dev, mesh=None) -> np.ndarray:
    m = stage_mesh(mesh, "sign_fix")
    if m is not None:
        from dipole_tpu_torch.parallel.sharding import potential_sharded

        mean = float(potential_sharded(pc, gen_grid(10), m).mean())
    else:
        mean = fields.measure_mean_potential(pc, device=dev)
    if mean < 0:
        pc[:, 3:6] *= -1
    return _unprep(pc, transform)


def simple_estimate(xyz_data, config, device="cuda", mesh=None):
    dev = resolve_device(device)
    mesh = _mesh(mesh, dev)
    pc, transform = _prep(xyz_data, 30, dev)
    m = stage_mesh(mesh, "greedy", len(pc))
    if m is not None:
        from dipole_tpu_torch.parallel.sharding import orient_points_multichip

        # propagation and sign fix in one sharded pass (the same decisions)
        pc = orient_points_multichip(pc, m, diffuse=config.get("diffuse", True),
                                     starting_point=0)
        return _unprep(pc, transform)
    pc = propagate.strongest_field_propagation_points(
        pc, diffuse=config.get("diffuse", True), starting_point=0, device=dev)
    return _finish(pc, transform, dev, mesh)


def xie_propagation(xyz_data, config, device="cuda", mesh=None):
    dev = resolve_device(device)
    mesh = _mesh(mesh, dev)
    pc, transform = _prep(xyz_data, config["max_nn"], dev)
    pc = propagate.xie_propagation_points(
        pc, eps=config["eps"], diffuse=config["diffuse"], starting_point=0,
        device=dev)
    return _finish(pc, transform, dev, mesh)


def tree_xie_propagation(xyz_data, config, device="cuda", mesh=None):
    dev = resolve_device(device)
    mesh = _mesh(mesh, dev)
    pc, transform = _prep(xyz_data, config["max_nn"], dev)
    pc, _ = propagate.xie_propagation_bfs_tree(
        pc, eps=config["eps"], diffuse=config["diffuse"],
        times=config["times"], starting_point=0,
        knn_mask=config.get("knn_mask", -1), C=config.get("C", 3),
        mesh=stage_mesh(mesh, "replay", len(pc)), device=dev)
    return _finish(pc, transform, dev, mesh)


def hoppe_estimate(xyz_data, config, device="cuda", mesh=None):
    dev = resolve_device(device)
    pc = np.asarray(xyz_data, dtype=np.float32)
    pc = estimate_normals(pc, max_nn=config.get("k_neighbor", 10),
                          radius=config.get("r", 0.1), device=dev)
    pc = graphs.orient_normals_hoppe(pc, k=config.get("k_neighbor", 10))
    return pc.astype(np.float64)


def graph_dipole_estimate(xyz_data, config, device="cuda", mesh=None):
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
             log=None, batcher=None, device="cuda", mesh=None) -> np.ndarray:
    """Run handler `function_name` on xyz_data, under `mesh` if given, else
    under the server-wide mesh (set_mesh). The micro-batcher takes a request
    only where the mesh keeps its stage on one device."""
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
    m = _mesh(mesh, resolve_device(device))
    if batcher is not None and function_name == "simple_estimate" \
            and stage_mesh(m, "greedy", len(xyz_data)) is None:
        from dipole_tpu_torch.serve.batching import batched_simple_estimate

        return batched_simple_estimate(batcher, xyz_data, config, device=device)
    if batcher is not None and function_name == "tree_xie_propagation" \
            and stage_mesh(m, "replay", len(xyz_data)) is None \
            and config.get("knn_mask", -1) <= 0:
        from dipole_tpu_torch.serve.batching import batched_tree_xie

        return batched_tree_xie(batcher, xyz_data, config, device=device)
    return HANDLERS[function_name](xyz_data, config, device=device, mesh=m)
