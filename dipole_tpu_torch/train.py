"""Training for the PointCNN flip classifier — the port of dipole_tpu/train.py.

Per-point binary classification of whether a normal is flipped relative to
the consistent orientation, trained on synthetically flipped patches (class
1 = keep, class 0 = flip, the voting convention of inference_utils.py:47-49)
or on patches of real clouds with ground-truth normals.

The JAX package jits one SPMD step over a (data, model) mesh; the port runs
the same step on a one-process parallel.sharding.Mesh: the batch split over
the 'data' axis, one replica of the model a data row, and the widest
weights (_TP_SUFFIXES) split over the 'model' axis on their output
dimension, each piece on its own device of the row (make_train_step). The
forward is models/pointcnn.PointCNN, whose kNN and FPS are the CUDA kernels
on the card, on every shard; its gradients go through torch autograd over
plain ops, as the JAX package's go through XLA outside its Pallas kernels. The optimizer is
optax's chain rebuilt by hand (ClipAdamW): clip_by_global_norm(1.0), then
adamw on a warmup-cosine schedule. Random draws are the JAX package's
(threefry keys in utils/prng.py), so init_params, make_batch and the FPS
starts of every step equal the JAX package's for the same seed.

    model, history = train(steps=2, batch=2, n_points=128, device="cpu")
    model, history, acc = train_on_clouds(["cloud.xyz"], steps=200)
    model, history = train(steps=2, batch=4, n_points=64, device="cpu",
                           mesh=make_mesh(4, device="cpu", shape=(2, 2)))
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.models.pointcnn import (PointCNN, _canonicalize, _gather,
                                              _interpolate, _pad_sizes,
                                              from_numpy_params, key_starts,
                                              pointcnn_logits)
from dipole_tpu_torch.ops.neighbors import fps_masked_batch, knn_with_dist
from dipole_tpu_torch.parallel.sharding import Mesh, _psum, make_mesh
from dipole_tpu_torch.utils import prng

__all__ = ["init_params", "make_batch", "calibrate_init", "loss_fn",
           "ClipAdamW", "warmup_cosine_schedule", "make_train_step",
           "param_sharding", "train", "patches_from_cloud", "assemble_batch",
           "train_on_clouds"]

# torch-style parameter shapes of a fresh PointCNN: (prefix, K, C_in, C_out)
_STAGES = [("encoder.conv1", 16, 6, 32), ("encoder.conv2", 20, 32, 64),
           ("encoder.conv3", 20, 64, 128), ("encoder.conv4", 20, 128, 256),
           ("decoder.conv1", 20, 256, 128), ("decoder.conv2", 20, 128, 64),
           ("decoder.conv3", 20, 64, 32)]

# leaves split over a mesh's 'model' axis on their output dimension (JAX
# train.py:36): the X-transform lifts and the stage output projections
_TP_SUFFIXES = ("mlp2.0.weight", "mlp2.0.bias", "conv.2.weight", "conv.2.bias")


def init_params(key) -> dict:
    """Glorot-uniform weights and zero biases in the checkpoint layout
    (JAX train.py:39-74), numpy float32, from a threefry key: the JAX
    package's draws, key for key."""
    params = {}

    def uniform(key, prefix, shape, fan):
        k1 = prng.split(key, 2)[0]
        lim = np.sqrt(np.float32(6.0 / fan))
        params[f"{prefix}.weight"] = prng.uniform_shape(k1, shape, -lim, lim)
        params[f"{prefix}.bias"] = np.zeros((shape[0],), np.float32)

    for prefix, K, C_in, C_out in _STAGES:
        cd = max(1, C_in // 4)
        dm = -(-C_out // C_in)
        key, *ks = prng.split(key, 6)
        uniform(ks[0], f"{prefix}.mlp1.0", (cd, 3), 3 + cd)
        uniform(ks[1], f"{prefix}.mlp1.3", (cd, cd), 2 * cd)
        uniform(ks[2], f"{prefix}.mlp2.0", (K * K, 3 * K), 3 * K + K * K)
        uniform(ks[3], f"{prefix}.mlp2.4", (K * K, 1, K), K + K * K)
        uniform(ks[4], f"{prefix}.mlp2.8", (K * K, 1, K), K + K * K)
        key, k1, k2 = prng.split(key, 3)
        uniform(k1, f"{prefix}.conv.0", (C_in * dm, 1, K), K + C_in * dm)
        uniform(k2, f"{prefix}.conv.2", (C_out, C_in * dm), C_in * dm + C_out)
    key, k1 = prng.split(key, 2)
    lim = np.sqrt(np.float32(6.0 / 34))
    params["decoder.lin4.weight"] = prng.uniform_shape(k1, (2, 32), -lim, lim)
    params["decoder.lin4.bias"] = np.zeros((2,), np.float32)
    return params


def _canonical_labels(labels: np.ndarray) -> np.ndarray:
    """Resolve the per-patch sign gauge (JAX train.py:154-161): a patch's
    orientation is defined up to one global flip, so take the gauge with
    fewer flips (majority 'keep')."""
    return labels if labels.mean() >= 0.5 else 1 - labels


def make_batch(key, batch: int, n_points: int, flip_frac: float = 0.4):
    """Synthetic batch (JAX train.py:77-97): noisy sphere-cap patches with a
    random subset of normals flipped, from numpy seeded by
    randint(key, (), 0, 2**31 - 1). Returns numpy (pc (B, N, 6) float32,
    labels (B, N) int32 {1 keep, 0 flip}, valid (B, N) bool)."""
    rng = np.random.default_rng(int(prng.randint(key, (), 0, 2**31 - 1)))
    pcs = np.empty((batch, n_points, 6), np.float32)
    labels = np.empty((batch, n_points), np.int32)
    for b in range(batch):
        center = rng.normal(size=3)
        center /= np.linalg.norm(center)
        v = rng.normal(size=(n_points, 3)) * 0.35 + center
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = v + rng.normal(scale=0.01, size=(n_points, 3))
        nrm = v.copy()
        flip = rng.random(n_points) < flip_frac
        nrm[flip] *= -1
        pcs[b, :, :3] = pts
        pcs[b, :, 3:] = nrm
        labels[b] = _canonical_labels((~flip).astype(np.int32))
    return pcs, labels, np.ones((batch, n_points), bool)


def _probe_patch(rng_seed: int = 0, n: int = 128) -> np.ndarray:
    """A noisy unit-sphere patch with exact normals (JAX train.py:146-151)."""
    rng = np.random.default_rng(rng_seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pc = np.concatenate([v + rng.normal(scale=0.01, size=(n, 3)), v], axis=1)
    return pc.astype(np.float32)


@torch.no_grad()
def calibrate_init(params: dict, probe_pc, pool: float = 0.6,
                   target_std: float = 1.0, device="cuda") -> dict:
    """LSUV-style calibration (JAX train.py:100-143): forward one probe
    patch stage by stage and rescale each stage's output projection
    (conv.2, lin4) so its pre-activation std (ddof 0) is ~target_std.
    Without it the 7-stage composition attenuates to logits of std ~4e-10.
    Returns the calibrated numpy params."""
    params = dict(params)
    dev = resolve_device(device)
    model = from_numpy_params(params, pool).to(dev)
    pc = torch.as_tensor(np.asarray(probe_pc, np.float32), device=dev)[None]
    n = pc.shape[1]
    valid = torch.ones((1, n), dtype=torch.bool, device=dev)
    m1, m2 = _pad_sizes(n, pool)
    x, pos1 = _canonicalize(pc, valid)

    def scaled(prefix, h):
        f = float(np.float32(target_std / max(float(torch.std(h, correction=0)), 1e-30)))
        for part in ("weight", "bias"):
            params[f"{prefix}.{part}"] = params[f"{prefix}.{part}"] * np.float32(f)
        return h * f

    def stage(prefix, h, pos):
        conv = model.get_submodule(prefix)
        idx, _ = knn_with_dist(pos, pos, conv.K)
        return F.relu(scaled(f"{prefix}.conv.2", conv(h, pos, idx)))

    start = torch.zeros(1, dtype=torch.int32)
    x = stage("encoder.conv1", x, pos1)
    sel1 = fps_masked_batch(pos1, valid, m1, start)
    pos2 = _gather(pos1, sel1)
    x = stage("encoder.conv2", _gather(x, sel1), pos2)
    sel2 = fps_masked_batch(pos2, torch.ones((1, m1), dtype=torch.bool, device=dev),
                            m2, start)
    pos3 = _gather(pos2, sel2)
    x = stage("encoder.conv3", _gather(x, sel2), pos3)
    x = stage("encoder.conv4", x, pos3)
    x = stage("decoder.conv1", x, pos3)
    x = stage("decoder.conv2", _interpolate(x, pos3, pos2), pos2)
    x = stage("decoder.conv3", _interpolate(x, pos2, pos1), pos1)
    scaled("decoder.lin4", model.decoder["lin4"](x))
    return params


def _loss_terms(model: PointCNN, pc, labels, valid, starts,
                class_balance: bool, gauge_free: bool, keep_bias: float):
    """loss_fn's sums over a block of patches: (loss numerator, loss
    denominator, acc numerator, acc denominator). Blocks add term by term,
    so the blocks of a batch split over a mesh's data rows give the loss and
    acc of the whole batch (not a mean of the blocks' means)."""
    starts = torch.as_tensor(starts)
    logits = model(pc, valid, starts[:, 0], starts[:, 1])
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    w = valid.to(torch.float32)
    w_inv = w
    if class_balance:
        pos = w * (labels == 1)
        neg = w * (labels == 0)
        n1 = pos.sum(-1, keepdim=True).clamp(min=1.0)
        n0 = neg.sum(-1, keepdim=True).clamp(min=1.0)
        kb = float(np.float32(keep_bias))
        kb_flip = float(np.float32(1) - np.float32(keep_bias))
        w = kb * pos / n1 + kb_flip * neg / n0
        # the inverted gauge swaps the class roles, so the bias swaps too
        w_inv = kb_flip * pos / n1 + kb * neg / n0
    vmask = valid.to(torch.float32)
    right = (logits.argmax(-1) == labels) & valid
    if gauge_free:
        inv = -logp.gather(-1, (1 - labels)[..., None])[..., 0]
        per_patch = torch.minimum(
            (nll * w).sum(-1) / w.sum(-1).clamp(min=1e-9),
            (inv * w_inv).sum(-1) / w_inv.sum(-1).clamp(min=1e-9))
        n = vmask.sum(-1).clamp(min=1.0)
        agree = right.sum(-1) / n
        patches = vmask.new_tensor(float(pc.shape[0]))
        return (per_patch.sum(), patches,
                torch.maximum(agree, vmask.sum(-1) / n - agree).sum(), patches)
    return (nll * w).sum(), w.sum(), right.sum().to(torch.float32), vmask.sum()


def _loss_of(num, den, right, count):
    """(loss, acc) from the summed _loss_terms."""
    return num / den.clamp(min=1e-9), right / count.clamp(min=1.0)


def loss_fn(model: PointCNN, pc, labels, valid, starts,
            class_balance: bool = False, gauge_free: bool = False,
            keep_bias: float = 0.5):
    """Per-point cross-entropy over the flip classes (JAX train.py:164-227)
    -> (loss, acc) tensors. pc (B, Nb, 6), labels (B, Nb) integer, valid
    (B, Nb) bool on the model's device; starts (B, 2) FPS starts
    (pointcnn.key_starts). Differentiable in the model's parameters.

    class_balance: both label classes get equal mass within each patch (the
    keep class keep_bias of it, the flip class 1 - keep_bias). gauge_free:
    each patch takes the smaller CE of its two label gauges (labels and
    1 - labels, the class masses swapped with them), and the loss is the
    mean over patches: a patch's orientation is only defined up to one
    flip, which propagation assigns later. Otherwise the loss is
    sum(nll w) / sum(w) over the whole batch."""
    return _loss_of(*_loss_terms(model, pc, labels, valid, starts,
                                 class_balance, gauge_free, keep_bias))


def warmup_cosine_schedule(learning_rate: float, total_steps: int):
    """optax.warmup_cosine_decay_schedule(0, lr, min(100, total // 10),
    total, lr * 0.05) (JAX train.py:254-256) as a function of the update
    count -> float32: linear from 0 over the warmup (so the first update's
    rate is 0 whenever there is a warmup), then a cosine to 5 % of lr."""
    warmup = min(100, total_steps // 10)
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    lr = np.float32(learning_rate)
    alpha = np.float32(0.0 if learning_rate == 0 else 0.05)

    def at(count: int) -> np.float32:
        if count < warmup:
            frac = np.float32(1) - np.float32(count) / np.float32(warmup)
            return -lr * frac + lr
        c = np.float32(min(count - warmup, decay))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c
                                                          / np.float32(decay)))
        return lr * ((np.float32(1) - alpha) * cosine + alpha)

    return at


class ClipAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule)) over a
    list of parameters, by hand (optax 0.2 defaults: b1 0.9, b2 0.999, eps
    1e-8 outside the root, weight decay 1e-4 on every parameter):

        g  <- g / |g|            where the global norm |g| >= max_norm
        mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
        u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p  <- p - schedule(t - 1) u      (t counts updates from 1)

    It differs from torch.optim.AdamW (decay 1e-2, decay applied apart),
    clip_grad_norm_ (divides by norm + 1e-6, always) and LambdaLR (one step
    behind the count). The norm and the clip stay on the device: a step
    reads nothing back. The parameters may lie on several devices (the
    masters of a mesh step): the global norm counts each tensor once."""

    def __init__(self, params, schedule, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params = list(params)
        self.schedule = schedule
        self.max_norm, self.b1, self.b2 = max_norm, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        # a parameter the forward never reads (XConv's mlp1) has no grad:
        # zeros, as JAX's gradient of it, so only the decay moves it
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        # the parameters of a mesh's replica live on several devices: their
        # norms meet on the first, and the scale goes back to each
        norms = torch._foreach_norm(grads)
        home = norms[0].device
        norm = torch.linalg.vector_norm(torch.stack([n.to(home) for n in norms]))
        # optax divides by the norm only when it reaches max_norm
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            norm / self.max_norm)
        for dev, idx in _by_device(grads).items():
            for i, g in zip(idx, torch._foreach_div([grads[i] for i in idx],
                                                    scale.to(dev))):
                grads[i] = g
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        lr = float(self.schedule(self.count))
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


def _by_device(tensors) -> dict:
    """{device: [indices of the tensors on it]}, in first-seen order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.device, []).append(i)
    return out


def param_sharding(mesh, params: dict) -> dict:
    """{name: pieces}: the number of pieces each parameter splits into over
    the mesh's 'model' axis, on its output dimension (dim 0), or 1 for a
    parameter kept whole — the JAX rule leaf for leaf (JAX
    train.py:233-244): a leaf ending in one of _TP_SUFFIXES splits when the
    mesh has a 'model' axis wider than 1 that divides its shape[0]. mesh: a
    parallel.sharding.Mesh, or None (every parameter whole)."""
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    return {k: m if m > 1 and k.endswith(_TP_SUFFIXES) and v.shape[0] % m == 0
            else 1 for k, v in params.items()}


def _train_mesh(mesh, dev: torch.device, batch: int | None = None):
    """The ("data", "model") mesh a training run takes, or None for one
    device. mesh: a Mesh (one axis is taken as 'data'), a count N (N
    devices of dev's type as (N, 1), the JAX package's layout) or None:
    with a batch on the card, every card, the data axis the largest divisor
    of the batch (JAX train.py:282-287); on the CPU one device. Raises
    ValueError for a mesh of another device type than dev, and for a data
    axis that does not divide the batch (as the JAX jit does)."""
    if mesh is None:
        if batch is None or dev.type != "cuda":
            return None
        d = torch.cuda.device_count()
        while batch % d:
            d -= 1
        mesh = d
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        if mesh == 1:
            return None
        mesh = make_mesh(int(mesh), device=dev.type, shape=(int(mesh), 1))
    if not isinstance(mesh, Mesh):
        raise ValueError(f"cannot train under mesh={mesh!r}: a Mesh, a device "
                         "count or None")
    if mesh.type != dev.type:
        raise ValueError(f"mesh {mesh} does not run on device {str(dev)!r}")
    if len(mesh.axis_names) == 1:
        mesh = Mesh(mesh.devices, shape=(mesh.size, 1))
    if batch is not None and batch % mesh.shape["data"]:
        raise ValueError(f"a data axis of {mesh.shape['data']} does not divide "
                         f"the batch of {batch}")
    return mesh if mesh.size > 1 else None


class _ColumnSplit(nn.Module):
    """A Linear split over the 'model' axis on its output dimension: piece j
    (rows [j out/m, (j+1) out/m) of the weight and bias, the parameters
    weight.j and bias.j) sits on devices[j]. The input goes to each piece's
    device, each piece computes its output columns, and they are
    concatenated on the input's device in piece order: the all-gather XLA
    inserts."""

    def __init__(self, linear: nn.Linear, devices):
        super().__init__()
        m = len(devices)
        self.weight = nn.ParameterList(
            nn.Parameter(w.detach().to(d, copy=True))
            for w, d in zip(linear.weight.chunk(m), devices))
        self.bias = nn.ParameterList(
            nn.Parameter(b.detach().to(d, copy=True))
            for b, d in zip(linear.bias.chunk(m), devices))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([F.linear(x.to(w.device), w, b).to(x.device)
                          for w, b in zip(self.weight, self.bias)], dim=-1)


def _row_replica(model: PointCNN, pieces: dict, devices) -> PointCNN:
    """A copy of `model` for one data row: its whole parameters on
    devices[0], and each Linear whose weight splits (pieces > 1) swapped for
    a _ColumnSplit over the row's devices."""
    rep = copy.deepcopy(model).to(devices[0])
    for name, mod in list(rep.named_modules()):
        if isinstance(mod, nn.Linear) and pieces[f"{name}.weight"] > 1:
            parent, key = name.rsplit(".", 1)
            rep.get_submodule(parent)[key] = _ColumnSplit(mod, devices)
    return rep


def _no_timer(_label: str):
    return contextlib.nullcontext()


def make_train_step(model: PointCNN, learning_rate: float = 1e-3,
                    total_steps: int = 2000, class_balance: bool = False,
                    gauge_free: bool = False, keep_bias: float = 0.5,
                    timer=None, mesh=None):
    """(opt, step) for `model` (JAX train.py:247-275): step(pc, labels,
    valid, starts) moves the host batch to the devices, runs loss_fn, its
    backward and one ClipAdamW update, and returns (loss, acc) tensors of
    the parameters before the update; step.gather() returns `model` holding
    the trained weights, and step.replicas lists the models the step trains
    (one a data row). Global-norm clipping and warmup-cosine because the
    XConv composition has sharp curvature (loss spikes of 50x without
    clipping on single-batch overfits). timer: as the pipelines'
    (api.orient_simple), label -> context manager, wrapped around the
    "forward", "backward" and "optimizer" parts of each step.

    mesh: None (one row: `model` itself, trained in place on its device), or
    a parallel.sharding.Mesh or device count as _train_mesh takes them.
    Under a mesh of d data rows each row holds a replica of the model (the
    split leaves of param_sharding as _ColumnSplit pieces over the row's
    devices, the rest whole on its first device); row 0's parameters are
    the masters that opt steps. A step splits the batch into d contiguous
    blocks in row order, as P("data") does (the FPS starts go with their
    patches), runs each block's forward on its row, sums the loss terms in
    row order on the mesh's first device (_psum) before the one division,
    runs one backward, sums each parameter's gradient over the rows in row
    order onto its master, updates the masters and copies them into the
    other rows. step.gather() concatenates the masters' pieces into
    `model`'s parameters, and their last gradients into its .grad, so the
    model is what one-device training leaves."""
    dev = next(model.parameters()).device
    timer = timer or _no_timer
    schedule = warmup_cosine_schedule(learning_rate, total_steps)
    mesh = _train_mesh(mesh, dev)
    pieces = param_sharding(mesh, dict(model.named_parameters()))
    if mesh is None:
        rows, home, firsts, replicas = 1, dev, [dev], [model]
    else:
        rows, home = mesh.shape["data"], mesh.devices[0]
        firsts = [mesh.row(r)[0] for r in range(rows)]
        replicas = [_row_replica(model, pieces, mesh.row(r)) for r in range(rows)]
    masters = list(replicas[0].parameters())
    others = [list(rep.parameters()) for rep in replicas[1:]]
    opt = ClipAdamW(masters, schedule)

    def step(pc, labels, valid, starts):
        if len(pc) % rows:
            raise ValueError(f"a data axis of {rows} does not divide the batch "
                             f"of {len(pc)}")
        b = len(pc) // rows
        with timer("forward"):
            terms = []
            for r, (rep, d) in enumerate(zip(replicas, firsts)):
                blk = slice(r * b, (r + 1) * b)
                terms.append(_loss_terms(
                    rep, torch.as_tensor(pc[blk], device=d),
                    torch.as_tensor(labels[blk], device=d),
                    torch.as_tensor(valid[blk], device=d), starts[blk],
                    class_balance, gauge_free, keep_bias))
            loss, acc = _loss_of(*(_psum(list(t), home) for t in zip(*terms)))
        with timer("backward"):
            for rep in replicas:
                rep.zero_grad(set_to_none=True)
            loss.backward()
            read = [i for i, p in enumerate(masters) if p.grad is not None]
            for params in others:
                torch._foreach_add_([masters[i].grad for i in read],
                                    [params[i].grad.to(masters[i].device) for i in read])
        with timer("optimizer"):
            opt.step()
            with torch.no_grad():
                for params in others:
                    torch._foreach_copy_(params, masters)
        return loss.detach(), acc.detach()

    def whole(held: dict, name: str, dev) -> torch.Tensor:
        if pieces[name] == 1:
            return held[name].to(dev)
        return torch.cat([held[f"{name}.{j}"].to(dev) for j in range(pieces[name])])

    @torch.no_grad()
    def gather() -> PointCNN:
        if replicas[0] is model:
            return model
        held = dict(replicas[0].named_parameters())
        grads = {k: p.grad for k, p in held.items()}
        for name, p in model.named_parameters():
            p.copy_(whole(held, name, p.device))
            p.grad = None if grads[name if pieces[name] == 1 else f"{name}.0"] is None \
                else whole(grads, name, p.device)
        return model

    step.gather, step.replicas = gather, replicas
    return opt, step


def _fresh_model(key, probe, pool: float, device) -> PointCNN:
    """A calibrated, trainable PointCNN on `device` from init_params(key)."""
    params = calibrate_init(init_params(key), probe, pool, device=device)
    return from_numpy_params(params, pool, trainable=True).to(device)


def train(steps: int = 20, batch: int = 8, n_points: int = 128,
          pool: float = 0.6, mesh=None, seed: int = 0,
          learning_rate: float = 1e-3, verbose: bool = True, device="cuda"):
    """Train a fresh PointCNN on synthetic flips (JAX train.py:278-309);
    returns (model, history [(loss, acc), ...]). mesh: a
    parallel.sharding.Mesh, a device count or None (_train_mesh; on the card
    None takes every card); the initial calibration runs on one device
    before the model is sharded, and the model returned is whole."""
    dev = resolve_device(device)
    mesh = _train_mesh(mesh, dev, batch)
    key = prng.prng_key(seed)
    key, pk = prng.split(key, 2)
    model = _fresh_model(pk, _probe_patch(seed, n_points), pool, dev)
    m1, _ = _pad_sizes(n_points, pool)
    _opt, step_fn = make_train_step(model, learning_rate, total_steps=steps,
                                    mesh=mesh)
    history = []
    for i in range(steps):
        key, bk, fk = prng.split(key, 3)
        pc, labels, valid = make_batch(bk, batch, n_points)
        loss, acc = step_fn(pc, labels, valid,
                            key_starts(fk, [n_points] * batch, pool, m1))
        history.append((float(loss), float(acc)))
        if verbose:
            print(f"step {i}: loss {history[-1][0]:.4f} acc {history[-1][1]:.4f}")
    return step_fn.gather(), history


# ---------------------------------------------------------------------------
# Training on real clouds (JAX train.py:312-509): patch the cloud, estimate
# unoriented normals, initialize with orient_center, and label each point by
# whether that initial normal agrees with the ground truth — the correction
# the ensemble applies inside orient_patches / orient_large.
# ---------------------------------------------------------------------------

def patches_from_cloud(path, number_parts: int = 30, min_patch: int = 100,
                       max_nn: int = 30, seed: int = 0, device="cuda"):
    """[(patch (n, 6) with orient_center-initialized estimated normals,
    labels (n,) int32)] from a ground-truth-oriented .xyz/.ply cloud. seed
    is accepted for the JAX package's signature; patching draws nothing."""
    from dipole_tpu_torch.ops.estimate import estimate_normals
    from dipole_tpu_torch.ops.patching import divide_pc
    from dipole_tpu_torch.utils.io import (Transform, load_point_cloud,
                                           orient_center_np)

    gt, _ = Transform.trans(load_point_cloud(path))
    est = estimate_normals(gt, max_nn=max_nn, device=device)
    out = []
    for idx in divide_pc(gt[:, :3], number_parts, min_patch=min_patch):
        patch = orient_center_np(est[idx])
        labels = ((patch[:, 3:6] * gt[idx, 3:6]).sum(-1) > 0).astype(np.int32)
        out.append((patch.astype(np.float32), _canonical_labels(labels)))
    return out


def _augment(patch, labels, rng, region_flip: float = 0.0,
             point_flip: float = 0.0, scramble: float = 0.0,
             region_draws: int = 1, region_range: tuple = (0.05, 0.5)):
    """Random rotation and whole-patch flip (labels invert), plus the JAX
    package's optional error patterns (train.py:338-395): scramble (every
    sign at random, w.p. scramble), region_draws draws of a contiguous
    region flip (the region_range fraction of points nearest a random
    seed, each w.p. region_flip), sparse point flips (2-15 % of points,
    w.p. point_flip). Every variant flips the input normals and inverts
    their labels, then the majority-keep gauge is restored."""
    q = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(q)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    p = patch.copy()
    p[:, :3] = p[:, :3] @ Q
    p[:, 3:6] = p[:, 3:6] @ Q
    lab = labels.copy()
    if scramble and rng.random() < scramble:
        mask = rng.random(len(p)) < 0.5
        p[mask, 3:6] *= -1
        lab[mask] = 1 - lab[mask]
    for _ in range(region_draws):
        if region_flip and rng.random() < region_flip:
            c = int(rng.integers(len(p)))
            m = max(1, int(len(p) * rng.uniform(*region_range)))
            d = ((p[:, :3] - p[c, :3]) ** 2).sum(-1)
            sel = np.argpartition(d, min(m, len(p) - 1))[:m]
            p[sel, 3:6] *= -1
            lab[sel] = 1 - lab[sel]
    if point_flip and rng.random() < point_flip:
        mask = rng.random(len(p)) < rng.uniform(0.02, 0.15)
        p[mask, 3:6] *= -1
        lab[mask] = 1 - lab[mask]
    if rng.random() < 0.5:
        p[:, 3:6] *= -1
        lab = 1 - lab
    return p, _canonical_labels(lab)


def assemble_batch(data, batch: int, bucket: int, rng, **augment):
    """One host batch of train_on_clouds: `batch` patches drawn from data,
    subsampled to `bucket` points, augmented and padded. Returns numpy (pc,
    labels, valid)."""
    pc = np.zeros((batch, bucket, 6), np.float32)
    lab = np.zeros((batch, bucket), np.int32)
    valid = np.zeros((batch, bucket), bool)
    samples = [data[rng.integers(len(data))] for _ in range(batch)]
    for i, (p, l) in enumerate(samples):
        if len(p) > bucket:
            sel = rng.permutation(len(p))[:bucket]
            p, l = p[sel], l[sel]
        p, l = _augment(p, l, rng, **augment)
        pc[i, :len(p)] = p
        lab[i, :len(p)] = l
        valid[i, :len(p)] = True
    return pc, lab, valid


def train_on_clouds(paths, steps: int = 200, batch: int = 8,
                    bucket: int = 512, pool: float = 0.6, seed: int = 0,
                    learning_rate: float = 3e-3, mesh=None,
                    eval_paths=(), verbose: bool = True,
                    number_parts: int = 30, min_patch: int = 100,
                    parts_list=None, class_balance: bool = False,
                    region_flip: float = 0.0, point_flip: float = 0.0,
                    scramble: float = 0.0, gauge_free: bool = False,
                    region_draws: int = 1,
                    region_range: tuple = (0.05, 0.5),
                    keep_bias: float = 0.5, extra_data=(),
                    snapshot_every: int = 0, snapshot_fn=None, device="cuda",
                    timer=None):
    """Train the flip classifier on GT-oriented clouds (JAX train.py:398-509).
    Returns (model, history, eval accuracy or None).

    paths: clouds, each patched once per number_parts value of parts_list
    (default [number_parts]), or (path, parts_list) pairs; extra_data: more
    (patch, labels) pairs (e.g. mined mid-pipeline states). snapshot_fn:
    called as snapshot_fn(step, model) every snapshot_every steps and at the
    last. eval_paths: held-out clouds scored after training (gauge-free per
    patch when training gauge-free). timer: label -> context manager around
    each step's "assembly" (the host batch and its FPS starts) and the parts
    make_train_step names. mesh: as train's; snapshot_fn, the held-out
    evaluation and the caller get the whole (gathered) model."""
    dev = resolve_device(device)
    mesh = _train_mesh(mesh, dev, batch)
    rng = np.random.default_rng(seed)
    data = []
    for p in paths:
        if isinstance(p, tuple):
            p, cloud_parts = p
        else:
            cloud_parts = parts_list or [number_parts]
        for nparts in cloud_parts:
            data.extend(patches_from_cloud(p, nparts, min_patch, seed=seed,
                                           device=dev))
    data.extend(extra_data)
    if not data:
        raise ValueError("no training patches")

    key = prng.prng_key(seed)
    key, pk = prng.split(key, 2)
    model = _fresh_model(pk, data[0][0][:min(len(data[0][0]), bucket)], pool, dev)
    m1, _ = _pad_sizes(bucket, pool)
    _opt, step_fn = make_train_step(model, learning_rate, total_steps=steps,
                                    class_balance=class_balance,
                                    gauge_free=gauge_free, keep_bias=keep_bias,
                                    timer=timer, mesh=mesh)
    timer = timer or _no_timer
    augment = dict(region_flip=region_flip, point_flip=point_flip,
                   scramble=scramble, region_draws=region_draws,
                   region_range=region_range)
    history = []
    for i in range(steps):
        with timer("assembly"):
            pc, lab, valid = assemble_batch(data, batch, bucket, rng, **augment)
            key, fk = prng.split(key, 2)
            starts = key_starts(fk, valid.sum(1), pool, m1)
        loss, acc = step_fn(pc, lab, valid, starts)
        history.append((float(loss), float(acc)))
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"step {i}: loss {history[-1][0]:.4f} acc {history[-1][1]:.4f}")
        if snapshot_fn and snapshot_every and (
                (i + 1) % snapshot_every == 0 or i == steps - 1):
            snapshot_fn(i + 1, step_fn.gather())

    model = step_fn.gather()
    eval_acc = None
    if eval_paths:
        correct = total = 0
        for p in eval_paths:
            for patch, lab in patches_from_cloud(p, number_parts, min_patch,
                                                 seed=seed + 1, device=dev):
                if len(patch) > bucket:
                    sel = rng.permutation(len(patch))[:bucket]
                    patch, lab = patch[sel], lab[sel]
                logits = pointcnn_logits(model, patch, key=prng.prng_key(0),
                                         bucket=bucket)
                match = int((logits.argmax(-1) == lab).sum())
                # gauge-free per patch when training gauge-free: the patch
                # sign belongs to propagation, not the net
                correct += max(match, len(lab) - match) if gauge_free else match
                total += len(lab)
        eval_acc = correct / max(total, 1)
        if verbose:
            print(f"eval accuracy on held-out clouds: {eval_acc:.4f}")
    return model, history, eval_acc
