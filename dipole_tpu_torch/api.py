"""In-memory orientation API — the port of dipole_tpu/api.py: per-point
propagation, the patch pipelines, and the xie, tree-xie and Hoppe methods of
`orient` (through serve/handlers.py), each on one device or over a mesh.

Arrays in, oriented (N, 6) float32 arrays out, in the ORIGINAL coordinate
space (normalization is internal). Every function takes `device` (default
"cuda"); "cuda" without a GPU raises. `mesh` takes a
parallel.sharding.Mesh, a device count (the first N cards, or N CPU shards
with device="cpu"), 'auto' or None (resolve_mesh); its stages shard as the
JAX package's decision table says (stage_mesh), and the other stages run on
`device`, whose type the mesh's devices must share.

    import dipole_tpu_torch
    oriented = dipole_tpu_torch.orient(points)                 # auto method
    oriented = dipole_tpu_torch.api.orient_simple(points, device="cpu")
    oriented = dipole_tpu_torch.api.orient_large(points, models=["m.pt"])
"""
from __future__ import annotations

import numpy as np
import torch

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.models.inference import (ensemble_vote_patches,
                                               load_model_from_file)
from dipole_tpu_torch.models.pointcnn import PointCNN
from dipole_tpu_torch.ops import _build, fields, propagate
from dipole_tpu_torch.ops.estimate import estimate_normals, estimate_normals_tensor
from dipole_tpu_torch.ops.patching import divide_pc, fix_n_filter
from dipole_tpu_torch.parallel.sharding import (Mesh, make_mesh, one_axis,
                                                orient_points_multichip,
                                                potential_sharded)
from dipole_tpu_torch.utils import prng
from dipole_tpu_torch.utils.io import (Transform, TensorTransform, gen_grid,
                                      orient_center_np)
from dipole_tpu_torch.utils.timing import span, timer_factory
from dipole_tpu_torch.utils.torch_rng import TorchMT19937

__all__ = ["orient", "orient_simple", "orient_simple_batch", "orient_patches",
           "orient_patches_consensus", "orient_large", "transfer_orientation",
           "resolve_mesh", "stage_mesh", "AutoMesh", "MAX_PATCH_SIZE",
           "ORIENT_SIMPLE_ROUTES"]

MAX_PATCH_SIZE = 500  # representatives per patch (reference orient_large.py:14)

# orient_simple calls by route: "card" keeps the cloud on the card between
# the stages, "host" passes numpy between them
ORIENT_SIMPLE_ROUTES = {"card": 0, "host": 0}


class AutoMesh:
    """Marker for --mesh auto: the mesh is available, and each stage picks
    sharded or one device by the decision table (stage_mesh)."""

    __slots__ = ("mesh",)

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __repr__(self):
        return f"AutoMesh({self.mesh!r})"


def resolve_mesh(mesh, device="cuda"):
    """Accept a Mesh, an AutoMesh, a device count (int or str), 'auto' or
    None (JAX api.py:47-76). None, a count of 1 or less, '', '0', 'none'
    and 'off' mean one device (the mesh paths bypassed); a mesh of one
    device too. A count N > 1 is make_mesh(N, device): the first N cards,
    or N CPU shards when `device` is the CPU; more cards than exist raise
    ValueError. A Mesh or a count FORCES the sharded path everywhere;
    'auto' is every card (CPU: make_mesh's default shards) under an
    AutoMesh marker, and each stage then decides (stage_mesh); one card
    means no mesh. A two-axis mesh (training's) raises ValueError."""
    if mesh is None:
        return None
    if isinstance(mesh, (Mesh, AutoMesh)):
        m = one_axis(mesh.mesh if isinstance(mesh, AutoMesh) else mesh)
        return mesh if m.size > 1 else None
    kind = torch.device(device).type
    if isinstance(mesh, str):
        key = mesh.strip().lower()
        if key in ("", "0", "none", "off"):
            return None
        if key == "auto":
            if kind == "cuda" and not torch.cuda.is_available():
                return None
            m = make_mesh(device=kind)
            return AutoMesh(m) if m.size > 1 else None
        mesh = int(key)
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        return None if mesh <= 1 else make_mesh(int(mesh), device=kind)
    raise ValueError(f"cannot resolve mesh from {mesh!r}")


def _mesh_for(mesh, dev: torch.device):
    """resolve_mesh(mesh, dev), refusing a mesh of another device type than
    `dev` (a CUDA mesh never hands its stages to the CPU, nor the reverse)."""
    mesh = resolve_mesh(mesh, dev)
    m = mesh.mesh if isinstance(mesh, AutoMesh) else mesh
    if m is not None and m.type != dev.type:
        raise ValueError(f"mesh {m} does not run on device {str(dev)!r}")
    return mesh


def _greedy_single_chip_max(device_type: str = "cuda") -> int:
    """The one-device greedy's point capacity: on a card, the kernels'
    2^24 (propagate_cuda.MAX_POINTS, where the wrappers refuse larger
    clouds); on the CPU the plain loop has no ceiling (JAX api.py:84-91).
    Auto reaches for the sharded loop only past it."""
    if device_type == "cuda":
        from dipole_tpu_torch.ops import propagate_cuda

        return propagate_cuda.MAX_POINTS
    return 2**62


def stage_mesh(mesh, stage: str, n: int | None = None):
    """Per-stage mesh for --mesh auto (JAX api.py:94-136). An explicit mesh
    passes through (the caller forced sharding). Under an AutoMesh the JAX
    package's decision table applies, kept as it is: 'ensemble' and 'field'
    shard (patches and targets are independent), and the sequential or
    collective-bound stages ('greedy', 'patch', 'replay', 'sign_fix') stay
    on one device, except the greedy past one device's capacity
    (_greedy_single_chip_max), where the sharded loop is the only path."""
    if mesh is None:
        return None
    if not isinstance(mesh, AutoMesh):
        return mesh
    if stage in ("ensemble", "field"):
        return mesh.mesh
    if stage == "greedy" and n is not None and n > _greedy_single_chip_max(mesh.mesh.type):
        return mesh.mesh
    return None


def _sign_fix(pc: np.ndarray, timer, device, mesh=None) -> np.ndarray:
    with timer("global sign fix"):
        if mesh is not None:
            mean = float(potential_sharded(pc, gen_grid(10), mesh).mean())
        else:
            mean = fields.measure_mean_potential(pc, device=device)
        if mean < 0:
            pc[:, 3:6] *= -1
    return pc


def orient_simple(points, diffuse: bool = False, estimate: bool = False,
                  n: int = 30, timer=None, mesh=None,
                  device="cuda") -> np.ndarray:
    """Per-point strongest-field propagation (reference orient_simple.py:8-34):
    (estimate) -> normalize -> propagate -> lattice sign fix -> denormalize.
    On a CUDA device with no mesh the cloud stays on the card from the
    upload of the positions to the copy back of the answer (the "card"
    route, _orient_simple_card); elsewhere each stage takes and gives numpy
    (the "host" route). Both give the same bits; ORIENT_SIMPLE_ROUTES counts
    the calls of each. mesh: the greedy's accumulator and the sign fix's
    sources shard over the mesh's devices
    (parallel.sharding.orient_points_multichip). A call is one
    `api.orient_simple` span that opens a request (utils/timing.py): its
    stages, `transform` and `transform.inverse` beneath it."""
    with span("api.orient_simple", request=True):
        dev = resolve_device(device)
        mesh = _mesh_for(mesh, dev)
        stage_timer = timer or timer_factory()
        input_pc = np.asarray(points, dtype=np.float32)
        route = "card" if dev.type == "cuda" and mesh is None else "host"
        _build.bump(ORIENT_SIMPLE_ROUTES, route)
        if route == "card":
            return _orient_simple_card(input_pc, diffuse, estimate, n, stage_timer, dev)

        if estimate or input_pc.shape[1] == 3:
            with stage_timer("estimate unoriented normals"):
                input_pc = estimate_normals(input_pc, max_nn=n, device=dev)

        with span("transform"):
            input_pc, transform = Transform.trans(input_pc)

        greedy_mesh = stage_mesh(mesh, "greedy", len(input_pc))
        if greedy_mesh is not None:
            with stage_timer("dipole propagation (multichip)"):
                input_pc = orient_points_multichip(input_pc, greedy_mesh,
                                                   diffuse=diffuse, starting_point=0)
        else:
            with stage_timer("dipole propagation"):
                input_pc = propagate.strongest_field_propagation_points(
                    input_pc, diffuse=diffuse, starting_point=0, device=dev)
            input_pc = _sign_fix(input_pc, stage_timer, dev)
        with span("transform.inverse"):
            return transform.inverse(input_pc)


def _orient_simple_card(input_pc: np.ndarray, diffuse: bool, estimate: bool, n: int,
                        stage_timer, dev: torch.device) -> np.ndarray:
    """orient_simple's stages on one (N, >=6) float32 tensor on the card:
    one upload (the positions, or the whole cloud given with normals), one
    copy back (the answer), and between them only the centre's upload and
    the sign fix's read of the mean potential. The centre is numpy's mean
    of the host positions (utils/io.TensorTransform). Each stage computes
    what the host route's does, bit for bit, under the host route's stage
    and span names."""
    if estimate or input_pc.shape[1] == 3:
        with stage_timer("estimate unoriented normals"):
            pos = np.ascontiguousarray(input_pc[:, :3])
            pc = estimate_normals_tensor(pos, max_nn=n, device=dev)
    else:
        pos = input_pc
        pc = torch.as_tensor(np.ascontiguousarray(input_pc), device=dev)
    with span("transform"):
        transform = TensorTransform(pos, pc)
        pc = transform.apply(pc)
    with stage_timer("dipole propagation"):
        pc = propagate.strongest_field_propagation_points(
            pc, diffuse=diffuse, starting_point=0, device=dev)
    pc = _sign_fix(pc, stage_timer, dev)
    with span("transform.inverse"):
        return transform.inverse(pc).cpu().numpy()


def orient_simple_batch(clouds, diffuse: bool = False, estimate: bool = False,
                        n: int = 30, device="cuda") -> list:
    """orient_simple for SEVERAL independent clouds in one batched device
    call (JAX api.py:196-219), the in-memory form of the server's
    micro-batching (serve/batching.py): the greedy orderings run as one
    batched launch (every cloud on the column greedy, whatever its size)
    and the sign fixes together, so B clouds cost about one cloud's time
    instead of B. Per-cloud results are independent of the batch; a single
    cloud delegates to orient_simple. Returns a list of (N_b, 6) arrays in
    original coordinates."""
    dev = resolve_device(device)
    clouds = [np.asarray(c, dtype=np.float32) for c in clouds]
    if not clouds:
        return []
    if len(clouds) == 1:
        return [orient_simple(clouds[0], diffuse=diffuse, estimate=estimate,
                              n=n, device=dev)]
    prepped, transforms = [], []
    for pc in clouds:
        if estimate or pc.shape[1] == 3:
            pc = estimate_normals(pc, max_nn=n, device=dev)
        pc, tr = Transform.trans(pc)
        prepped.append(pc)
        transforms.append(tr)
    oriented = propagate.orient_clouds_batched(prepped, diffuse=diffuse, device=dev)
    return [tr.inverse(o) for o, tr in zip(oriented, transforms)]


def _as_models(models, dev):
    """Checkpoint paths or loaded PointCNN modules, on `dev`."""
    return [m.to(dev) if isinstance(m, PointCNN)
            else load_model_from_file(m, device=dev) for m in (models or [])]


def _check_vote_flags(fix_when: str, fix_vote: str) -> None:
    if fix_when not in ("last", "every"):
        raise ValueError(f"fix_when must be 'last' or 'every', got {fix_when!r}")
    if fix_vote not in ("all", "mean"):
        raise ValueError(f"fix_vote must be 'all' or 'mean', got {fix_vote!r}")


def _fix_probs(fix_models, patches, sub, fix_vote: str, fps_starts: str,
               mesh=None):
    """(probs, probs_by_model) per patch for the staged fix pass: under
    fix_vote 'all' each fixer votes alone and a point's P(flip) is the
    largest (every fixer must clear the margin); under 'mean' the fixers
    vote together (one entry per patch in probs_by_model)."""
    if fix_vote == "all":
        per_model = [ensemble_vote_patches([m], patches, key=sub, mesh=mesh,
                                           fps_starts=fps_starts)
                     for m in fix_models]
        by_model = [[pm[i][1] for pm in per_model] for i in range(len(patches))]
        return [np.max(ps, axis=0) for ps in by_model], by_model
    probs = [p for _f, p in ensemble_vote_patches(fix_models, patches, key=sub,
                                                  mesh=mesh, fps_starts=fps_starts)]
    return probs, [[p] for p in probs]


def orient_patches(points, models=(), iters: int = 100,
                   propagation_iters: int = 10, number_parts: int = 15,
                   minimum_points_per_patch: int = 21,
                   curvature_threshold: float = 0.0, diffuse: bool = False,
                   weighted_prop: bool = False, estimate: bool = False,
                   n: int = 30, timer=None, mesh=None,
                   torch_rng: int | None = None, vote_starts: int = 1,
                   fps_starts: str = "rng", vote_margin: float = 0.0,
                   fix_models=(), fix_margin: float = 0.25,
                   fix_when: str = "last", fix_vote: str = "all",
                   fix_stats: dict | None = None, vote_seed: int = 1,
                   device="cuda") -> np.ndarray:
    """Patch pipeline with PointCNN ensemble correction (reference
    orient_pointcloud.py:11-83, JAX api.py:223-437): voxel patches ->
    curvature filter -> orient_center -> iterate {ensemble votes, periodic
    patch propagation} -> staged fix pass -> final propagation -> lattice
    sign fix. The options are the JAX package's: vote_starts, fps_starts
    ('rng' | 'centroid'), vote_margin (flip only where P(flip) < 0.5 -
    margin), fix_models / fix_margin / fix_when / fix_vote / fix_stats (the
    staged per-point fix pass), vote_seed (base seed of the vote keys),
    torch_rng (an int seed: the main vote's FPS starts replay the
    reference's torch.manual_seed(seed) stream, one stream a call shared by
    every iteration; the fix pass keeps its threefry keys). mesh: the
    ensemble's patch batch and the patch propagation's pair work shard over
    the mesh's devices (results unchanged)."""
    if torch_rng is not None and int(vote_starts) != 1:
        raise ValueError("vote_starts > 1 is incompatible with torch_rng "
                         "replay (one start per model by definition)")
    if torch_rng is not None and fps_starts != "rng":
        raise ValueError("fps_starts='centroid' is incompatible with "
                         "torch_rng replay (the replayed stream defines "
                         "the starts)")
    dev = resolve_device(device)
    mesh = _mesh_for(mesh, dev)
    rng_stream = None if torch_rng is None else TorchMT19937(int(torch_rng))
    _check_vote_flags(fix_when, fix_vote)
    stage_timer = timer or timer_factory()
    pc = np.asarray(points, dtype=np.float32)
    if estimate or pc.shape[1] == 3:
        with stage_timer("estimate unoriented normals"):
            pc = estimate_normals(pc, max_nn=n, device=dev)
    input_pc, transform = Transform.trans(pc)

    models = _as_models(models, dev)
    fix_models = _as_models(fix_models, dev)

    with stage_timer("voxel patching"):
        all_patches = divide_pc(input_pc[:, :3], number_parts,
                                min_patch=minimum_points_per_patch)
    with stage_timer("curvature filter"):
        patch_indices = fix_n_filter(input_pc, all_patches, curvature_threshold)
    print(f"number of patches {len(patch_indices)}")
    with stage_timer("centroid init"):
        for _, p in patch_indices:
            input_pc[p] = orient_center_np(input_pc[p])

    pc_probs = np.ones(len(input_pc), dtype=np.float32)
    key = prng.prng_key(vote_seed)

    def propagate_now():
        return propagate.strongest_field_propagation_patches(
            input_pc, patch_indices, all_patches, diffuse=diffuse,
            weights=pc_probs if weighted_prop else None,
            mesh=stage_mesh(mesh, "patch", len(input_pc)), device=dev)

    def fix_pass():
        # staged per-point fix pass: fixers flip only margin-clearing,
        # strict-minority point sets (a majority flip is a gauge claim)
        nonlocal key
        if not (fix_models and patch_indices):
            return
        key, sub = prng.split(key, 2)
        patches_now = [input_pc[pidx] for _, pidx in patch_indices]
        plist, by_model = _fix_probs(fix_models, patches_now, sub, fix_vote,
                                     fps_starts, stage_mesh(mesh, "ensemble"))
        records = []
        for i, ((_, pidx), probs) in enumerate(zip(patch_indices, plist)):
            flip = probs < (0.5 - fix_margin)
            guarded = bool(flip.mean() >= 0.5)
            if fix_stats is not None:
                records.append(dict(pidx=pidx, probs_by_model=by_model[i],
                                    normals=patches_now[i][:, 3:6].copy(),
                                    probs=probs, flip=flip, guarded=guarded))
            if guarded:
                continue
            pc_probs[pidx[flip]] = 1 - probs[flip]
            input_pc[pidx[flip], 3:6] *= -1
        if fix_stats is not None:
            fix_stats.setdefault("passes", []).append(records)

    for it in range(iters):
        with stage_timer(f"iteration {it}"):
            if models and patch_indices:
                key, sub = prng.split(key, 2)
                votes = ensemble_vote_patches(
                    models, [input_pc[pidx] for _, pidx in patch_indices],
                    key=sub, mesh=stage_mesh(mesh, "ensemble"),
                    torch_rng=rng_stream, vote_starts=vote_starts,
                    fps_starts=fps_starts)
                for (_, pidx), (flip, probs) in zip(patch_indices, votes):
                    if vote_margin:
                        flip = probs < (0.5 - vote_margin)
                    probs = probs.copy()
                    probs[flip] = 1 - probs[flip]
                    pc_probs[pidx] = probs
                    input_pc[pidx[flip], 3:6] *= -1
            if fix_when == "every":
                fix_pass()
            if it % propagation_iters == 0 and (it != 0 or propagation_iters == 1):
                with stage_timer("patch propagation"):
                    input_pc = propagate_now()

    if fix_when == "last":
        with stage_timer("fix pass"):
            fix_pass()
    with stage_timer("patch propagation"):
        input_pc = propagate_now()
    input_pc = _sign_fix(input_pc, stage_timer, dev, stage_mesh(mesh, "sign_fix"))
    return transform.inverse(input_pc)


def orient_patches_consensus(points, models=(), runs: int = 3,
                             vote_seeds=None, **kwargs) -> np.ndarray:
    """Consensus of runs (JAX api.py:440-468): orient_patches under `runs`
    decorrelated vote seeds (1..runs by default), then each point keeps its
    majority sign, each run first aligned to run 0's global gauge. An even
    run count breaks ties with run 0's sign, as in the JAX package."""
    if vote_seeds is None:
        vote_seeds = list(range(1, int(runs) + 1))
    outs = [orient_patches(points, models=models, vote_seed=s, **kwargs)
            for s in vote_seeds]
    base = outs[0].copy()
    votes = np.zeros(len(base), np.int64)
    for o in outs:
        s = np.where((o[:, 3:6] * base[:, 3:6]).sum(-1) >= 0, 1, -1)
        votes += s * (1 if s.sum() >= 0 else -1)
    base[votes < 0, 3:6] *= -1
    return base


def orient_large(points, models=(), iters: int = 100, number_parts: int = 15,
                 minimum_points_per_patch: int = 21,
                 curvature_threshold: float = 0.0, estimate: bool = False,
                 n: int = 30, seed: int = 1, timer=None, mesh=None,
                 vote_starts: int = 1, fps_starts: str = "rng",
                 vote_margin: float = 0.0, fix_models=(),
                 fix_margin: float = 0.25, fix_when: str = "last",
                 fix_vote: str = "all", vote_seed: int = 1,
                 device="cuda") -> np.ndarray:
    """Large clouds through <= 500 random representatives per patch
    (reference orient_large.py:10-90, JAX api.py:471-593): normalize ->
    (estimate normals, after normalization as in the reference) -> voxel
    patches -> curvature filter -> orient_center -> `iters` ensemble rounds
    on the representatives -> representative propagation (diffuse), rest
    points re-voted by the field of the oriented representatives -> lattice
    sign fix. Options as orient_patches; mesh: the ensemble forwards, the
    representatives' group interaction and the rest-point field pass shard
    over the mesh's devices."""
    dev = resolve_device(device)
    mesh = _mesh_for(mesh, dev)
    _check_vote_flags(fix_when, fix_vote)
    stage_timer = timer or timer_factory()
    input_pc, transform = Transform.trans(np.asarray(points, dtype=np.float32))
    if estimate or input_pc.shape[1] == 3:
        with stage_timer("estimate unoriented normals"):
            input_pc = estimate_normals(input_pc, max_nn=n, device=dev)

    models = _as_models(models, dev)
    fix_models = _as_models(fix_models, dev)

    with stage_timer("voxel patching"):
        all_patches = divide_pc(input_pc[:, :3], number_parts,
                                min_patch=minimum_points_per_patch)
    with stage_timer("curvature filter"):
        patch_indices = fix_n_filter(input_pc, all_patches, curvature_threshold)
    print(f"number of patches {len(patch_indices)}/{len(all_patches)}")
    with stage_timer("centroid init"):
        for _, p in patch_indices:
            input_pc[p] = orient_center_np(input_pc[p])
    with stage_timer("pick representatives"):
        rng = np.random.default_rng(seed)
        represent = []
        for p in all_patches:
            perm = rng.permutation(len(p))
            represent.append((p[perm[:MAX_PATCH_SIZE]], p[perm[MAX_PATCH_SIZE:]]))

    pc_probs = np.ones(len(input_pc), dtype=np.float32)
    key = prng.prng_key(vote_seed)
    with stage_timer("network correction"):
        rep_sets = [represent[i][0] for i, _ in patch_indices] if models else []

        def fix_pass():
            nonlocal key
            if not (fix_models and rep_sets):
                return
            key, sub = prng.split(key, 2)
            plist, _ = _fix_probs(fix_models, [input_pc[r] for r in rep_sets],
                                  sub, fix_vote, fps_starts,
                                  stage_mesh(mesh, "ensemble"))
            for reps, probs in zip(rep_sets, plist):
                flip = probs < (0.5 - fix_margin)
                if flip.mean() >= 0.5:
                    continue
                pc_probs[reps[flip]] = 1 - probs[flip]
                input_pc[reps[flip], 3:6] *= -1

        # the reference re-votes each patch `iters` times; the patches are
        # independent, so each round is one batched ensemble pass
        for _ in range(iters if rep_sets else 0):
            key, sub = prng.split(key, 2)
            votes = ensemble_vote_patches(
                models, [input_pc[r] for r in rep_sets], key=sub,
                mesh=stage_mesh(mesh, "ensemble"), vote_starts=vote_starts,
                fps_starts=fps_starts)
            for reps, (flip, probs) in zip(rep_sets, votes):
                if vote_margin:
                    flip = probs < (0.5 - vote_margin)
                pc_probs[reps] = probs
                input_pc[reps[flip], 3:6] *= -1
            if fix_when == "every":
                fix_pass()
        if fix_when == "last":
            fix_pass()

    with stage_timer("dipole propagation"):
        input_pc = propagate.strongest_field_propagation_reps(
            input_pc, represent, diffuse=True,
            mesh=stage_mesh(mesh, "patch", len(input_pc)), device=dev)
    input_pc = _sign_fix(input_pc, stage_timer, dev, stage_mesh(mesh, "sign_fix"))
    return transform.inverse(input_pc)


def transfer_orientation(reference_pc, target, estimate: bool = False,
                         n: int = 30, device="cuda") -> np.ndarray:
    """Orient `target` by the dipole field of an oriented reference cloud
    (reference reference_orientation.py:8-28, JAX api.py:596-606): 3-column
    targets take the normalized field as their normal, 6-column targets only
    its sign. No normalization, no sign fix."""
    dev = resolve_device(device)
    target = np.asarray(target, dtype=np.float32)
    if estimate:
        target = estimate_normals(target, max_nn=n, device=dev)
    return fields.reference_field(reference_pc, target, device=dev)


def orient(points, method: str = "auto", models=(), **kwargs) -> np.ndarray:
    """One-call orientation. method: 'auto' | 'simple' | 'patches' |
    'large' | 'xie' | 'tree_xie' | 'hoppe'. 'auto' picks as the JAX package
    does: 'large' above 50k points, else 'patches' with models and 'simple'
    without. xie/tree_xie/hoppe take the server protocol's config keys
    (serve/handlers.py) as kwargs, with the JAX defaults (n -> max_nn 30,
    eps 1.0, diffuse False, times 3; hoppe: n -> k_neighbor 10); like the
    server they take xyz only and re-estimate the normals; a `mesh` among
    the kwargs is the one the handler runs under (handlers.dispatch)."""
    points = np.asarray(points)
    if method == "auto":
        if len(points) > 50_000:
            method = "large"
        else:
            method = "patches" if models else "simple"
    if method == "simple":
        return orient_simple(points, **kwargs)
    if method == "patches":
        return orient_patches(points, models=models, **kwargs)
    if method == "large":
        return orient_large(points, models=models, **kwargs)
    if method in ("xie", "tree_xie", "hoppe"):
        from dipole_tpu_torch.serve import handlers

        device = kwargs.pop("device", "cuda")
        mesh = kwargs.pop("mesh", None)
        name = {"xie": "xie_propagation", "tree_xie": "tree_xie_propagation",
                "hoppe": "hoppe_estimate"}[method]
        if method == "hoppe":
            # hoppe_estimate reads k_neighbor/r, not max_nn
            config = {"k_neighbor": kwargs.pop("n", 10), **kwargs}
        else:
            config = {"max_nn": kwargs.pop("n", 30), "eps": 1.0,
                      "diffuse": False, "times": 3, **kwargs}
        out = handlers.dispatch(name, points[:, :3], config, device=device,
                                mesh=mesh)
        return np.asarray(out, dtype=np.float32)
    raise ValueError(f"unknown method {method!r}")
