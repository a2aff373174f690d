"""PointCNN flip classifier as torch modules — the port of
dipole_tpu/models/pointcnn.py (architecture :42-44, XConv :130-180,
composition :272-338, canonicalization :238-269, batching :418-721).

Model: per-patch input (N, 6) [xyz + unoriented normal] -> per-point
2-class logits [keep, flip]. Encoder: 4 XConv stages (6->32->64->128->256,
kernel sizes 16/20/20/20) with farthest-point pooling between stages;
decoder: 3 XConv + inverse-distance kNN interpolation + a final linear to 2
channels. Input is canonicalized per patch: centred, rotated to PCA axes,
xyz scaled by the square root of the largest eigenvalue.

The parameters keep the reference's torch names (`encoder.conv1.mlp2.0.
weight`, ...), so the checkpoints of `pre_trained_tpu/` load into
`PointCNN` as they are, and `from_numpy_params` builds the module from the
JAX package's flat parameter dict.

Batching is the JAX package's: patches are padded to a power-of-two bucket
with a validity mask threaded through every stage; padded rows sit at a 1e6
sentinel position with zero features. The forward runs a whole chunk of
patches at once, each patch reading only its own rows. The neighbour
searches (ops/neighbors.py: kNN and FPS, CUDA kernels on the card) and the
FPS start indices are explicit: the start indices come from the same
threefry keys as in the JAX package (utils/prng.py), so both packages make
the same selections.
"""
from __future__ import annotations

import copy
import hashlib
import math
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dipole_tpu_torch.ops.fields import sqrt_rn
from dipole_tpu_torch.ops.linalg import eigh3x3
from dipole_tpu_torch.ops.neighbors import fps_masked_batch, knn_with_dist
from dipole_tpu_torch.parallel.sharding import one_axis
from dipole_tpu_torch.utils import prng

__all__ = ["XConv", "PointCNN", "from_numpy_params", "ENCODER", "DECODER",
           "centroid_starts", "key_starts", "prepare_patch_batches",
           "pointcnn_logits_batched", "pointcnn_logits"]

_SENTINEL = 1.0e6

# (K, C_in, C_out) per stage, from the reference architecture
ENCODER = [(16, 6, 32), (20, 32, 64), (20, 64, 128), (20, 128, 256)]
DECODER = [(20, 256, 128), (20, 128, 64), (20, 64, 32)]

# widest batch per forward chunk (JAX pointcnn.py:493-500): the chunk
# width sets the peak memory of a forward, not its results
MAX_FORWARD_ELEMS = 131072
MAX_FORWARD_BATCH = 256
POOL_WIDE = 0.8


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x (B, N, C) and integer idx (B, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)
    rows = rows.view(-1, *([1] * (idx.dim() - 1)))
    return x[rows, idx.long()]


def _clip_bound(n: int) -> float:
    """Clamp of pos_diff: covers any valid-valid pair of z-scored coords
    (max |z| = sqrt(n)) with margin, far below the 1e6 sentinel (JAX
    pointcnn.py:124-127). n is the padded row count of the stage."""
    return max(64.0, 4.0 * float(n) ** 0.5)


class XConv(nn.Module):
    """One XConv stage (reference models/XConv.py:119-157, JAX
    pointcnn.py:130-180) on a batch: the X-transform from each point's K
    neighbour offsets (Linear 3K -> K^2 and two per-group K -> K maps), the
    transformed neighbour features, a depthwise conv over the K neighbours
    and a linear out.

    `mlp1` (offsets -> C_in/4 lifted features) is part of the checkpoints
    but never applied: every stage of the forward receives features, as in
    the JAX package (pointcnn.py:153-158)."""

    def __init__(self, K: int, C_in: int, C_out: int):
        super().__init__()
        self.K, self.C_in = K, C_in
        self.dm = -(-C_out // C_in)
        c_delta = C_in // 4
        self.mlp1 = nn.ModuleDict({"0": nn.Linear(3, c_delta),
                                   "3": nn.Linear(c_delta, c_delta)})
        self.mlp2 = nn.ModuleDict({
            "0": nn.Linear(3 * K, K * K),
            "4": nn.Conv1d(K, K * K, K, groups=K),
            "8": nn.Conv1d(K, K * K, K, groups=K)})
        self.conv = nn.ModuleDict({
            "0": nn.Conv1d(C_in, C_in * self.dm, K, groups=C_in),
            "2": nn.Linear(C_in * self.dm, C_out)})

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
        """x (B, N, C_in), pos (B, N, 3), idx (B, N, >=K) self-kNN of pos
        (its first K columns are the K-nearest, the scan selecting in
        distance order) -> (B, N, C_out)."""
        B, N, K = x.shape[0], x.shape[1], self.K
        idx = idx[..., :K]
        bound = _clip_bound(N)
        pos_diff = (_gather(pos, idx) - pos[:, :, None, :]).clamp(-bound, bound)
        x_knn = _gather(x, idx)                                  # (B, N, K, C)

        m2 = self.mlp2
        T = F.elu(m2["0"](pos_diff.reshape(B, N, K * 3))).reshape(B, N, K, K)
        for name, act in (("4", True), ("8", False)):
            w = m2[name].weight.reshape(K, K, K)                 # (g, o, t)
            T = torch.einsum("bngt,got->bngo", T, w) + m2[name].bias.reshape(K, K)
            if act:
                T = F.elu(T)
        # x_transformed[b, n, c, k] = sum_j T[b, n, k, j] x_knn[b, n, j, c]
        xt = torch.einsum("bnkj,bnjc->bnck", T, x_knn)
        w0 = self.conv["0"].weight.reshape(self.C_in, self.dm, K)
        out = torch.einsum("bnct,cmt->bncm", xt, w0) \
            + self.conv["0"].bias.reshape(self.C_in, self.dm)
        return self.conv["2"](out.reshape(B, N, self.C_in * self.dm))


def _pad_sizes(nb: int, pool: float):
    """The padded FPS sizes of a bucket: m1 = ceil(nb pool), m2 = ceil(m1 pool)."""
    m1 = int(-(-nb * pool // 1))
    return m1, int(-(-m1 * pool // 1))


def _pool_valid(valid: torch.Tensor, pool: float, m: int) -> torch.Tensor:
    """Validity mask (B, m) of the next pooling stage: the first
    ceil(pool * n_valid) slots, in float32 as the JAX package computes it."""
    counts = torch.ceil(torch.tensor(pool, dtype=torch.float32)
                        * valid.sum(dim=-1).to(torch.float32)).to(torch.int64)
    return torch.arange(m, device=valid.device) < counts[:, None].to(valid.device)


def _canonicalize(pc: torch.Tensor, valid: torch.Tensor):
    """Centre, PCA-rotate (xyz scaled by sqrt of the largest eigenvalue,
    normals rotated unscaled) — JAX pointcnn.py:238-261. pc (B, N, 6), valid
    (B, N) -> features (B, N, 6) (0 on padding) and positions (B, N, 3)
    (sentinel on padding)."""
    w = valid.to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)                     # (B, 1)
    xyz = pc[..., :3]
    xyz = xyz - (xyz * w).sum(dim=1, keepdim=True) / cnt[:, None]
    temp = xyz * w
    cov = temp.transpose(1, 2) @ temp / cnt[:, :, None]
    e, V = eigh3x3(cov)
    scale = sqrt_rn(torch.clamp(e[:, 2], min=1e-20))
    rot = (xyz @ V) / scale[:, None, None]
    nrm = pc[..., 3:6] @ V
    pos1 = torch.where(valid[..., None], rot, torch.full_like(rot, _SENTINEL))
    x = torch.where(valid[..., None], torch.cat([rot, nrm], dim=-1),
                    torch.zeros_like(pc))
    return x, pos1


def _interpolate(x, pos_src, pos_dst, k: int = 16):
    """Inverse-squared-distance kNN interpolation (JAX pointcnn.py:211-235)."""
    idx, d2 = knn_with_dist(pos_dst, pos_src, k)
    w = 1.0 / torch.clamp(d2, min=1e-16)
    xk = _gather(x, idx)
    return (xk * w[..., None]).sum(dim=2) / w.sum(dim=2, keepdim=True)


class PointCNN(nn.Module):
    """The flip classifier with its pool ratio: the port of the JAX
    package's PointCNNParams (pointcnn.py:375-415) as a module. Parameter
    names are the reference checkpoints'."""

    def __init__(self, pool: float = 0.6):
        super().__init__()
        self.pool = float(pool)
        self.encoder = nn.ModuleDict(
            {f"conv{i + 1}": XConv(*s) for i, s in enumerate(ENCODER)})
        self.decoder = nn.ModuleDict(
            {f"conv{i + 1}": XConv(*s) for i, s in enumerate(DECODER)})
        self.decoder["lin4"] = nn.Linear(DECODER[-1][2], 2)
        self._digest = None

    @property
    def content_digest(self) -> int:
        """Stable 31-bit digest of the weights and pool ratio, the JAX
        package's (pointcnn.py:387-401). Ensemble voting folds it into the
        per-model keys, so results do not depend on the models' order. It is
        cached until the weights change: any in-place write to a parameter
        (an optimizer step, load_state_dict) moves the tensor's version
        counter, and a new tensor has another address."""
        state = self.state_dict()
        stamp = (self.pool, tuple((k, v.data_ptr(), v._version)
                                  for k, v in state.items()))
        if self._digest is None or self._digest[0] != stamp:
            h = hashlib.sha256()
            for k in sorted(state):
                h.update(k.encode())
                h.update(state[k].detach().cpu().numpy().astype(np.float32).tobytes())
            h.update(np.float32(self.pool).tobytes())
            self._digest = (stamp, int.from_bytes(h.digest()[:4], "little") & 0x7FFFFFFF)
        return self._digest[1]

    @staticmethod
    def from_files(pt_path, txt_path=None) -> "PointCNN":
        from dipole_tpu_torch.models.checkpoints import (load_model_opts,
                                                         load_state_dict)

        pt_path = Path(pt_path)
        txt_path = txt_path or pt_path.with_suffix(".txt")
        return from_numpy_params(load_state_dict(pt_path),
                                 load_model_opts(txt_path)["pool"])

    def fps_selections(self, pos1, valid, m1: int, m2: int, s1, s2):
        """The two pooling stages' FPS for the whole batch (JAX
        pointcnn.py:330-338): (sel1, valid2, pos2, sel2)."""
        sel1 = fps_masked_batch(pos1, valid, m1, s1)
        valid2 = _pool_valid(valid, self.pool, m1)
        pos2 = torch.where(valid2[..., None], _gather(pos1, sel1),
                           torch.full((1, 1, 1), _SENTINEL, device=pos1.device))
        sel2 = fps_masked_batch(pos2, valid2, m2, s2)
        return sel1, valid2, pos2, sel2

    def forward_sels(self, x, pos1, sel1, valid2, pos2, sel2):
        """The network with both FPS selections given (JAX
        pointcnn.py:272-305). Each position set is kNN-searched once (k=20)
        and the search shared by every stage on that set."""
        enc, dec = self.encoder, self.decoder
        m2 = sel2.shape[1]
        idx1, _ = knn_with_dist(pos1, pos1, 20)
        x = F.relu(enc["conv1"](x, pos1, idx1))

        x = _gather(x, sel1)
        idx2, _ = knn_with_dist(pos2, pos2, 20)
        x = F.relu(enc["conv2"](x, pos2, idx2))

        valid3 = _pool_valid(valid2, self.pool, m2)
        x = _gather(x, sel2)
        pos3 = torch.where(valid3[..., None], _gather(pos2, sel2),
                           torch.full((1, 1, 1), _SENTINEL, device=pos2.device))
        idx3, _ = knn_with_dist(pos3, pos3, 20)
        x = F.relu(enc["conv3"](x, pos3, idx3))
        x = F.relu(enc["conv4"](x, pos3, idx3))

        x = F.relu(dec["conv1"](x, pos3, idx3))
        x = _interpolate(x, pos3, pos2)
        x = F.relu(dec["conv2"](x, pos2, idx2))
        x = _interpolate(x, pos2, pos1)
        x = F.relu(dec["conv3"](x, pos1, idx1))
        return dec["lin4"](x)

    def forward(self, pc, valid, s1, s2):
        """Padded batched forward: pc (B, Nb, 6), valid (B, Nb) bool, FPS
        starts s1 (B,) within the valid rows and s2 (B,) within the pooled
        ones -> logits (B, Nb, 2). The padded FPS sizes are
        m1 = ceil(Nb pool), m2 = ceil(m1 pool). Differentiable in the
        parameters (the selections are integer)."""
        x, pos1 = _canonicalize(pc, valid)
        return self.forward_precanon(x, pos1, valid, s1, s2)

    def forward_precanon(self, x, pos, valid, s1, s2):
        """The forward on inputs already canonicalized (JAX
        pointcnn.py:474-479, the torch_rng replay's path): features x
        (B, Nb, 6), 0 on padding, and positions pos (B, Nb, 3), the sentinel
        on padding."""
        m1, m2 = _pad_sizes(x.shape[1], self.pool)
        sels = self.fps_selections(pos, valid, m1, m2, s1, s2)
        return self.forward_sels(x, pos, *sels)


def from_numpy_params(params: dict, pool: float,
                      trainable: bool = False) -> PointCNN:
    """PointCNN on the CPU from a flat parameter dict keyed by the torch
    names — the JAX package's parameters (dipole_tpu/models/checkpoints.py,
    PointCNNParams.params), train.init_params or a checkpoint read as numpy.
    Frozen in eval mode (inference) unless `trainable`."""
    model = PointCNN(pool)
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in params.items()}, strict=True)
    return model if trainable else model.eval().requires_grad_(False)


def _bucket(n: int, base: int = 128) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def _forward_width(bucket: int, pool: float = 0.6) -> int:
    elems = MAX_FORWARD_ELEMS // 2 if pool > POOL_WIDE else MAX_FORWARD_ELEMS
    return max(8, min(MAX_FORWARD_BATCH, elems // bucket))


def centroid_starts(patches) -> np.ndarray:
    """Deterministic FPS starts (JAX pointcnn.py:563-579): stage 1 at the
    patch point nearest the centroid, stage 2 at pooled index 0 (the
    stage-1 start). (len(patches), 2) int32."""
    st = np.zeros((len(patches), 2), np.int32)
    for i, p in enumerate(patches):
        xyz = np.asarray(p, np.float32)[:, :3]
        d = xyz - xyz.mean(axis=0)
        st[i, 0] = int(np.argmin(np.einsum("ij,ij->i", d, d)))
    return st


def key_starts(key, lens, pool: float, m1: int) -> np.ndarray:
    """The FPS starts the JAX package derives on the device from `key` for
    a call over patches of sizes `lens` (pointcnn.py:454-460, 700-701):
    patch i's key is split(key, len)[i], split again into the two stages'
    keys; each start is _random_valid_index over that stage's valid count.
    (len(lens), 2) int32."""
    lens = np.asarray(lens, np.int64)
    k1, k2 = prng.split2(prng.split(key, len(lens)))
    n2 = np.minimum(np.ceil(np.float32(pool) * lens.astype(np.float32)), m1)
    return np.stack([prng.random_valid_index(k1, lens),
                     prng.random_valid_index(k2, n2.astype(np.int64))],
                    axis=1).astype(np.int32)


def prepare_patch_batches(patches, bucket: int, width: int, device, mesh=None):
    """Pad patches into (pc, valid) chunk tensors on `device` once, shared by
    every model pass of an ensemble call (JAX pointcnn.py:582-603). Chunk
    rows are padded to a power of two of at least 8. With a mesh
    (parallel.sharding.Mesh) each chunk of `width` patches is split over
    its devices (np.array_split's slices of the chunk, each padded and
    placed on its shard's device; JAX shards the chunk's patch axis).
    Returns [(pc, valid, lo, lens), ...]."""
    prepared = []
    for lo in range(0, len(patches), width):
        chunk = list(range(lo, min(lo + width, len(patches))))
        parts = ([(chunk, device)] if mesh is None else
                 [(list(c), d) for c, d in
                  zip(np.array_split(np.asarray(chunk), mesh.size), mesh.devices)])
        for idx, dev in parts:
            if not len(idx):
                continue
            Bp = _bucket(len(idx), base=8)
            pc = np.zeros((Bp, bucket, 6), np.float32)
            valid = np.zeros((Bp, bucket), bool)
            for i, pi in enumerate(idx):
                pc[i, :len(patches[pi])] = patches[pi]
                valid[i, :len(patches[pi])] = True
            prepared.append((torch.as_tensor(pc, device=dev),
                             torch.as_tensor(valid, device=dev), int(idx[0]),
                             [len(patches[pi]) for pi in idx]))
    return prepared


_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replica(model: "PointCNN", device) -> "PointCNN":
    """The model on `device`: itself where it lives, else a copy made once
    and kept until the model's weights change (the per-shard replica of a
    sharded forward)."""
    device = torch.device(device)
    if next(model.parameters()).device == device:
        return model
    stamp = tuple((p.data_ptr(), p._version) for p in model.parameters())
    cache = _REPLICAS.setdefault(model, {})
    held = cache.get(device)
    if held is None or held[0] != stamp:
        held = (stamp, copy.deepcopy(model).to(device))
        cache[device] = held
    return held[1]


@torch.no_grad()
def pointcnn_logits_batched(model: PointCNN, patches, key=None, bucket=None,
                            starts=None, prepared=None, device=None,
                            precanon: bool = False, mesh=None) -> list:
    """The forward over many ragged patches (JAX pointcnn.py:606-721):
    patches padded to one bucket and run in chunks of at most
    _forward_width(bucket, pool). starts: optional (len(patches), 2) FPS
    start indices; by default they are derived from `key` (a threefry key,
    default PRNGKey(0)) as the JAX package derives them, per patch, so no
    start depends on the chunks or the shards. prepared: the
    prepare_patch_batches result of this call's patches, bucket and width
    (and mesh). precanon: the patches are already canonicalized (the
    torch_rng replay, inference._canon_reference): the forward skips its
    own, on one device (a mesh is ignored, as in the JAX package). mesh: a
    parallel.sharding.Mesh; each chunk, mesh.size times as wide, is split
    over its devices, each running a replica of the model (the kNN and FPS
    kernels launch on each shard; every shard is launched before any result
    is read back; a two-axis mesh raises ValueError). Returns a list of
    (n_i, 2) float32 numpy arrays."""
    patches = [np.asarray(p, np.float32) for p in patches]
    if not patches:
        return []
    dev = device or next(model.parameters()).device
    if precanon:
        mesh = None
    elif mesh is not None:
        one_axis(mesh)
    nb = bucket or _bucket(max(len(p) for p in patches))
    m1, _ = _pad_sizes(nb, model.pool)
    if starts is None:
        starts = key_starts(prng.prng_key(0) if key is None else key,
                            [len(p) for p in patches], model.pool, m1)
    starts = np.asarray(starts, np.int32)
    if (starts.shape != (len(patches), 2) or (starts < 0).any()
            or (starts[:, 0] >= nb).any() or (starts[:, 1] >= m1).any()):
        # checked here, on the host: the FPS kernel does not read them back
        raise ValueError(f"starts: expected ({len(patches)}, 2) indices in "
                         f"[0, {nb}) and [0, {m1}), the two stages' rows")
    if prepared is None:
        width = _forward_width(nb, model.pool) * (1 if mesh is None else mesh.size)
        prepared = prepare_patch_batches(patches, nb, width, dev, mesh)
    elif sum(len(lens) for *_, lens in prepared) != len(patches) \
            or any(pc.shape[1] != nb for pc, *_ in prepared):
        raise ValueError("prepared batches do not match this call's patches "
                         "and bucket")
    launched = []
    for pc, valid, lo, lens in prepared:
        st = np.zeros((pc.shape[0], 2), np.int32)
        st[:len(lens)] = starts[lo:lo + len(lens)]
        st = torch.as_tensor(st, device=pc.device)
        if precanon:
            pos = torch.where(valid[..., None], pc[..., :3],
                              torch.full((1, 1, 1), _SENTINEL, device=pc.device))
            out = model.forward_precanon(pc, pos, valid, st[:, 0], st[:, 1])
        else:
            out = _replica(model, pc.device)(pc, valid, st[:, 0], st[:, 1])
        launched.append((out, lo, lens))
    results: list = [None] * len(patches)
    for out, lo, lens in launched:
        out = out.cpu().numpy()
        for i, n in enumerate(lens):
            results[lo + i] = out[i, :n]
    return results


def pointcnn_logits(model: PointCNN, patch, key=None, bucket=None) -> np.ndarray:
    """Per-point 2-class logits for one (n, 6) patch padded to `bucket`
    (default the power of two from 128 up); the FPS starts come from
    split(key) as in the JAX package's single-patch forward
    (pointcnn.py:342-353, 724-736)."""
    patch = np.asarray(patch, np.float32)
    n, nb = len(patch), bucket or _bucket(len(patch))
    m1, _ = _pad_sizes(nb, model.pool)
    k1, k2 = prng.split(prng.prng_key(0) if key is None else key, 2)
    n2 = min(int(math.ceil(np.float32(model.pool) * np.float32(n))), m1)
    st = np.array([[prng.random_valid_index(k1, n),
                    prng.random_valid_index(k2, n2)]], np.int32)
    return pointcnn_logits_batched(model, [patch], bucket=nb, starts=st)[0]
