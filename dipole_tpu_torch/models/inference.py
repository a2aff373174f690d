"""Ensemble inference — the port of dipole_tpu/models/inference.py:15-30,
:66-234 (reference inference_utils.py).

load_model_from_file (:38-44) -> PointCNN.from_files on a device
voting_policy (:47-49)        -> mean softmax flip probability, flip < 0.5

Keys are threefry keys (utils/prng.py), derived exactly as the JAX package
derives them, so both packages draw the same FPS starts: per model the key
folds the checkpoint's content digest, each extra vote start folds
0x9E3779B9 + s, and the call's shared bucket size is folded last. The
torch_rng replay draws the starts from the reference's MT19937 stream
instead (utils/torch_rng.py) and canonicalizes the patches as the reference
does (_canon_reference).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.models.pointcnn import (PointCNN, _bucket,
                                              _forward_width, centroid_starts,
                                              pointcnn_logits,
                                              pointcnn_logits_batched,
                                              prepare_patch_batches)
from dipole_tpu_torch.utils import prng

__all__ = ["load_model_from_file", "voting_policy", "ensemble_vote",
           "ensemble_vote_patches"]


def load_model_from_file(path, device="cuda") -> PointCNN:
    return PointCNN.from_files(path).to(resolve_device(device))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def voting_policy(probs_list):
    """Mean per-point P(flip) across models; flip where < 0.5 (reference
    inference_utils.py:47-49). Returns (flip_mask, probs)."""
    probs = np.stack([np.asarray(p) for p in probs_list], axis=0).mean(axis=0)
    return probs < 0.5, probs


def _canon_reference(patch: np.ndarray) -> np.ndarray:
    """The reference's patch canonicalization (reference models/pointcnn.py:
    36-38 and util.rotate_to_principle_components, util.py:503-517; JAX
    inference.py:32-63): centre xyz, rotate to the covariance's
    eigenvectors (xyz scaled by the square root of the largest eigenvalue,
    normals unscaled).

    Always on the CPU: LAPACK's eigenvector signs are what this path exists
    to reproduce (JAX inference.py:38-42: 137 of 2734 flips differed under
    another basis), and cuSOLVER's are not LAPACK's."""
    x = torch.tensor(np.asarray(patch, np.float32), device="cpu")
    x[:, :3] -= x[:, :3].mean(dim=0)
    temp = x[:, :3] - x.mean(dim=0)[None, :3]
    cov = temp.transpose(0, 1) @ temp / x.shape[0]
    e, v = torch.linalg.eigh(cov, UPLO="U")  # torch.symeig's default half
    rotated = (x[:, :3] @ v) / torch.sqrt(e[2])
    return torch.cat([rotated, x[:, 3:] @ v], dim=-1).numpy()


def _model_key(key, model, index: int):
    """Per-model key folded over the checkpoint's content digest (not its
    place in the list), or the index for a model without a digest."""
    digest = getattr(model, "content_digest", None)
    return prng.fold_in(key, digest if digest is not None else index)


def ensemble_vote(models, patch, key=None):
    """Run every model on one patch and vote. Returns (flip_mask, probs)."""
    key = prng.prng_key(0) if key is None else key
    votes = [_softmax(pointcnn_logits(m, patch, key=_model_key(key, m, mi)))[:, 1]
             for mi, m in enumerate(models)]
    return voting_policy(votes)


def ensemble_vote_patches(models, patches, key=None, mesh=None, torch_rng=None,
                          vote_starts: int = 1, fps_starts: str = "rng"):
    """Ensemble-vote many ragged patches at once (JAX inference.py:94-234):
    all patches share one padded bucket, are padded and moved to the
    models' device once, and each model (and vote start) runs one batched
    forward over them. Returns a list of (flip_mask, probs) aligned with
    `patches`. mesh: a parallel.sharding.Mesh; the patch batch is split over
    its devices, a model replica on each (the torch_rng replay stays on one
    device, as in the JAX package).

    vote_starts: votes per model with independent FPS starts (1 = the
    reference). fps_starts: 'rng' (key-derived random starts) or 'centroid'
    (the patch point nearest the centroid, no start noise). torch_rng: a
    utils.torch_rng.TorchMT19937 stream: the starts are drawn from it in the
    reference's order (per patch, then per model: randint(n), then
    randint(ceil(pool n))) and the patches canonicalized as the reference
    does, replaying the torch pipeline's randomness. The stream is stateful:
    pass the same one across iterations. One start per model, so it takes
    neither vote_starts > 1 nor fps_starts='centroid'."""
    patches = [np.asarray(p, np.float32) for p in patches]
    vote_starts = int(vote_starts)
    if vote_starts < 1:
        raise ValueError("vote_starts must be >= 1")
    if torch_rng is not None and vote_starts != 1:
        raise ValueError("vote_starts > 1 is incompatible with the torch_rng "
                         "replay (the replayed stream defines exactly one "
                         "start per model per patch)")
    if fps_starts not in ("rng", "centroid"):
        raise ValueError(f"fps_starts must be 'rng' or 'centroid', "
                         f"got {fps_starts!r}")
    if fps_starts == "centroid" and torch_rng is not None:
        raise ValueError("fps_starts='centroid' is incompatible with the "
                         "torch_rng replay (the replayed stream defines the "
                         "starts)")
    if fps_starts == "centroid" and vote_starts != 1:
        raise ValueError("vote_starts > 1 needs random starts; "
                         "fps_starts='centroid' defines exactly one")
    key = prng.prng_key(0) if key is None else key
    # one shared bucket for the whole call; it is also folded into the keys
    bucket = _bucket(max(len(p) for p in patches))
    det_starts = centroid_starts(patches) if fps_starts == "centroid" else None
    if torch_rng is not None:
        return _replay_votes(models, patches, torch_rng, bucket)

    n_votes = len(models) * vote_starts
    probs_per_vote = [[None] * len(patches) for _ in range(n_votes)]
    prepared_cache: dict = {}
    for mi, model in enumerate(models):
        mkey = _model_key(key, model, mi)
        dev = next(model.parameters()).device
        width = _forward_width(bucket, model.pool) * (1 if mesh is None else mesh.size)
        place = dev if mesh is None else mesh
        if (width, place) not in prepared_cache:
            prepared_cache[(width, place)] = prepare_patch_batches(
                patches, bucket, width, dev, mesh)
        for s in range(vote_starts):
            skey = mkey if s == 0 else prng.fold_in(mkey, 0x9E3779B9 + s)
            outs = pointcnn_logits_batched(
                model, patches, key=prng.fold_in(skey, bucket), bucket=bucket,
                starts=det_starts, prepared=prepared_cache[(width, place)],
                mesh=mesh)
            for i, logits in enumerate(outs):
                probs_per_vote[mi * vote_starts + s][i] = _softmax(logits)[:, 1]
    return [voting_policy([probs_per_vote[v][i] for v in range(n_votes)])
            for i in range(len(patches))]


def _replay_votes(models, patches, torch_rng, bucket: int):
    """The torch_rng replay's votes (JAX inference.py:162-177): starts drawn
    patch-major, model-inner, then every model over the canonicalized
    patches on the shared bucket."""
    starts = np.zeros((len(models), len(patches), 2), np.int32)
    for pi, p in enumerate(patches):
        for mi, model in enumerate(models):
            starts[mi, pi, 0] = torch_rng.randint(len(p))
            starts[mi, pi, 1] = torch_rng.randint(math.ceil(model.pool * len(p)))
    # the reference canonicalizes per model call; input and recipe are the
    # same each time, so once serves every model
    canon = [_canon_reference(p) for p in patches]
    votes = [[_softmax(logits)[:, 1] for logits in pointcnn_logits_batched(
                 model, canon, bucket=bucket, starts=starts[mi], precanon=True)]
             for mi, model in enumerate(models)]
    return [voting_policy([v[i] for v in votes]) for i in range(len(patches))]
