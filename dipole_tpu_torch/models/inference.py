"""Ensemble inference — the port of dipole_tpu/models/inference.py:15-30,
:66-234 (reference inference_utils.py).

load_model_from_file (:38-44) -> PointCNN.from_files on a device
voting_policy (:47-49)        -> mean softmax flip probability, flip < 0.5

Keys are threefry keys (utils/prng.py), derived exactly as the JAX package
derives them, so both packages draw the same FPS starts: per model the key
folds the checkpoint's content digest, each extra vote start folds
0x9E3779B9 + s, and the call's shared bucket size is folded last.
"""
from __future__ import annotations

import numpy as np

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.models.pointcnn import (PointCNN, _bucket,
                                              _forward_width, centroid_starts,
                                              pointcnn_logits,
                                              pointcnn_logits_batched,
                                              prepare_patch_batches)
from dipole_tpu_torch.utils import prng

__all__ = ["load_model_from_file", "voting_policy", "ensemble_vote",
           "ensemble_vote_patches", "TORCH_RNG_SLICE"]

TORCH_RNG_SLICE = ("the torch_rng replay (utils/torch_rng.py, the reference's "
                   "MT19937 FPS starts) is not ported yet; it is a later "
                   "slice of the port (ROADMAP.md, module item 7)")


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


def ensemble_vote_patches(models, patches, key=None, torch_rng=None,
                          vote_starts: int = 1, fps_starts: str = "rng"):
    """Ensemble-vote many ragged patches at once (JAX inference.py:94-234):
    all patches share one padded bucket, are padded and moved to the
    models' device once, and each model (and vote start) runs one batched
    forward over them. Returns a list of (flip_mask, probs) aligned with
    `patches`.

    vote_starts: votes per model with independent FPS starts (1 = the
    reference). fps_starts: 'rng' (key-derived random starts) or 'centroid'
    (the patch point nearest the centroid, no start noise). torch_rng: the
    reference's MT19937 replay, not ported yet (raises)."""
    if torch_rng is not None:
        raise NotImplementedError(TORCH_RNG_SLICE)
    patches = [np.asarray(p, np.float32) for p in patches]
    vote_starts = int(vote_starts)
    if vote_starts < 1:
        raise ValueError("vote_starts must be >= 1")
    if fps_starts not in ("rng", "centroid"):
        raise ValueError(f"fps_starts must be 'rng' or 'centroid', "
                         f"got {fps_starts!r}")
    if fps_starts == "centroid" and vote_starts != 1:
        raise ValueError("vote_starts > 1 needs random starts; "
                         "fps_starts='centroid' defines exactly one")
    key = prng.prng_key(0) if key is None else key
    # one shared bucket for the whole call; it is also folded into the keys
    bucket = _bucket(max(len(p) for p in patches))
    det_starts = centroid_starts(patches) if fps_starts == "centroid" else None

    n_votes = len(models) * vote_starts
    probs_per_vote = [[None] * len(patches) for _ in range(n_votes)]
    prepared_cache: dict = {}
    for mi, model in enumerate(models):
        mkey = _model_key(key, model, mi)
        dev = next(model.parameters()).device
        width = _forward_width(bucket, model.pool)
        if (width, dev) not in prepared_cache:
            prepared_cache[(width, dev)] = prepare_patch_batches(
                patches, bucket, width, dev)
        for s in range(vote_starts):
            skey = mkey if s == 0 else prng.fold_in(mkey, 0x9E3779B9 + s)
            outs = pointcnn_logits_batched(
                model, patches, key=prng.fold_in(skey, bucket), bucket=bucket,
                starts=det_starts, prepared=prepared_cache[(width, dev)])
            for i, logits in enumerate(outs):
                probs_per_vote[mi * vote_starts + s][i] = _softmax(logits)[:, 1]
    return [voting_policy([probs_per_vote[v][i] for v in range(n_votes)])
            for i in range(len(patches))]
