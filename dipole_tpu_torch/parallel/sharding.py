"""Multi-device execution on a one-process device mesh — the port of
dipole_tpu/parallel/sharding.py.

A `Mesh` is a list of torch devices driven by one Python process, as a JAX
`Mesh` is: `make_mesh(n)` takes the first n cards, `make_mesh(n,
device="cpu")` gives n CPU shards (the test mesh, the counterpart of the JAX
tests' 8 virtual CPU devices), and a mesh may name one card several times
(`Mesh([torch.device("cuda:0")] * 4)`): four virtual shards that run the
sharded code with the real kernels on one card. A mesh holds devices of one
type; on a CUDA mesh every shard launches the hand-written kernels
(ops/fields.py's dispatch), never their plain versions, and no shard moves
to the CPU. A mesh has one axis, or two: `make_mesh(4, device="cpu",
shape=(2, 2))` is a ("data", "model") mesh, training's
(train.make_train_step); the functions below take one-axis meshes and
refuse a two-axis one (one_axis).

Layouts, as in the JAX package:
  * target-sharded: each shard holds a slice of the targets and all the
    sources; no communication (the lattice sign fix, the rest-point re-vote);
  * source-sharded: each shard holds a slice of the sources and all the
    targets; the partial fields are summed (psum);
  * ring: each shard holds a slice of the sources and of the targets; the
    source slices rotate one shard along the ring D times (ppermute), so
    a shard holds O(N / D) of the cloud.

Collectives are plain torch in a fixed shard order, so results do not
depend on timing: psum moves the partials to shard 0's device and adds them
in shard order; all-gather concatenates the shards in order; ppermute is
`.to(the next shard's device)` (a peer copy between cards, nothing on one
card). Shards are `torch.tensor_split` slices and need no padding: the JAX
package pads only because shard_map wants equal shards, and its padding rows
contribute exactly nothing, so the results are the same. Work on different
cards overlaps: every shard's kernel is launched before any result is read
back.

The two sequential loops (the strongest-field greedy and the order replay)
are XLA scans in the JAX package, with no Pallas kernel, so here they are
plain torch loops; neither reads a value back to the host during its steps.
"""
from __future__ import annotations

import numpy as np
import torch

from dipole_tpu_torch.device import as_f32, resolve_device
from dipole_tpu_torch.ops import fields
from dipole_tpu_torch.utils.io import gen_grid

__all__ = ["Mesh", "make_mesh", "field_grad_sharded", "potential_sharded",
           "interaction_accumulate_sharded", "pad_cloud_for_ring",
           "greedy_sign_sequence_sharded", "orient_points_multichip",
           "xie_in_order_sharded", "point_group_interaction_sharded"]

CPU_SHARDS = 8          # make_mesh(device="cpu")'s default shard count
_SENTINEL = 1.0e6       # pad_cloud_for_ring's position (zero moment)


class Mesh:
    """One process's device mesh: `devices` (a tuple of torch.device, repeats
    allowed), `size`, `axis_names` and `shape` ({axis name: length}, JAX's
    mesh.shape). One axis, named `axis`, by default. shape=(d, m) gives the
    two axes ("data", "model") with the devices in data-major order, as
    Mesh(np.array(devs).reshape(d, m), ("data", "model")) in JAX: row(i) is
    data shard i's m devices, column(j) the d devices that hold model piece
    j. Raises ValueError for an empty list, devices of more than one type, a
    card that does not exist, an axis that is not one name, or a shape that
    does not hold the devices."""

    def __init__(self, devices, axis: str = "data", shape=None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {kinds}")
        if kinds[0] == "cuda":
            resolve_device("cuda")
            count = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", torch.cuda.current_device()
                                      if d.index is None else d.index) for d in devs)
            if any(d.index >= count for d in devs):
                raise ValueError(f"mesh {[str(d) for d in devs]}: only {count} "
                                 "CUDA device(s) are available")
        elif kinds[0] != "cpu":
            raise ValueError(f"unsupported mesh device type {kinds[0]!r}")
        dims = (len(devs),) if shape is None else tuple(int(s) for s in shape)
        if not isinstance(axis, str):
            raise ValueError(f"axis names a one-axis mesh, got {axis!r}; a "
                             "two-axis mesh's axes are ('data', 'model')")
        if not 1 <= len(dims) <= 2:
            raise ValueError(f"a mesh has one or two axes, got shape {dims}")
        names = (axis,) if len(dims) == 1 else ("data", "model")
        if min(dims) < 1 or int(np.prod(dims)) != len(devs):
            raise ValueError(f"mesh shape {dims} does not hold {len(devs)} devices")
        self.devices = devs
        self.size = len(devs)
        self.axis_names = names
        self.shape = dict(zip(names, dims))
        self.type = kinds[0]
        self._cols = dims[1] if len(dims) == 2 else 1

    def row(self, i: int) -> tuple:
        """The devices of data shard i: one on a one-axis mesh."""
        return self.devices[i * self._cols:(i + 1) * self._cols]

    def column(self, j: int) -> tuple:
        """The devices that hold model piece j, one a data shard."""
        return self.devices[j::self._cols]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape})")


def make_mesh(n_devices: int | None = None, device="cuda", axis: str = "data",
              shape=None) -> Mesh:
    """The first n_devices cards (default: all, or the product of `shape`),
    or n CPU shards with device="cpu" (default CPU_SHARDS); `axis` and
    `shape` as Mesh's. Asking for more cards than exist raises ValueError:
    silently shrinking would fake the validation."""
    kind = torch.device(device).type
    if n_devices is None and shape is not None:
        n_devices = int(np.prod(shape))
    if kind == "cpu":
        n = CPU_SHARDS if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh of {n} devices")
        return Mesh([torch.device("cpu")] * n, axis, shape)
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device type {kind!r}")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if n_devices is None else int(n_devices)
    if not 1 <= n <= avail:
        raise ValueError(
            f"requested a {n}-device mesh but only {avail} CUDA device(s) "
            "are available (silently shrinking would fake the validation)")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis, shape)


def one_axis(mesh: Mesh) -> Mesh:
    """`mesh`, refused with ValueError when it has two axes: the pipeline's
    shards are one list of devices, and it does not guess which axis to
    split (a two-axis mesh is training's, train.make_train_step)."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{mesh}: the sharded pipeline takes a one-axis mesh, "
                         f"not axes {mesh.axis_names}")
    return mesh


# ---------------------------------------------------------------------------
# shards and collectives
# ---------------------------------------------------------------------------

def _host(x, cols: int) -> torch.Tensor:
    """A float32 (N, cols) tensor where x lives (numpy: the CPU)."""
    dev = x.device if isinstance(x, torch.Tensor) else "cpu"
    return as_f32(x, dev)[:, :cols]


def _shards(x: torch.Tensor, mesh: Mesh) -> list:
    """Row slices of x, one on each shard's device, in shard order."""
    return [p.to(d).contiguous() for p, d in
            zip(torch.tensor_split(x, mesh.size), mesh.devices)]


def _replicate(x: torch.Tensor, mesh: Mesh) -> dict:
    """{device: x there}: one copy a distinct device."""
    return {d: x.to(d).contiguous() for d in dict.fromkeys(mesh.devices)}


def _psum(parts: list, dev) -> torch.Tensor:
    """Sum of the shards' partials on `dev`, added in shard order."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def _gather(parts: list) -> np.ndarray:
    """The shards' rows in shard order, as one host array."""
    return torch.cat([p.cpu() for p in parts]).numpy()


def _field(src: torch.Tensor, tgt: torch.Tensor, eps: float) -> torch.Tensor:
    if not (len(src) and len(tgt)):
        return torch.zeros((len(tgt), 3), dtype=torch.float32, device=tgt.device)
    return fields.field_grad(src, tgt, eps)


def _potential(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    if not (len(src) and len(tgt)):
        return torch.zeros(len(tgt), dtype=torch.float32, device=tgt.device)
    return fields.potential(src, tgt)


def _ring(src_shards: list, tgt_shards: list, mesh: Mesh, fn) -> list:
    """Sources and targets both sharded: each target shard adds fn(its
    current source shard, itself), then every source shard moves one shard
    along the ring (j -> j + 1), D times in all. Returns the per-shard sums
    on their devices (the output stays sharded like the targets)."""
    n = mesh.size
    cur = list(src_shards)
    out = [None] * n
    for step in range(n):
        for j in range(n):
            part = fn(cur[j], tgt_shards[j])
            out[j] = part if out[j] is None else out[j] + part
        if step < n - 1:
            cur = [cur[(j - 1) % n].to(mesh.devices[j]) for j in range(n)]
    return out


def pad_cloud_for_ring(pts, n_dev: int, block: int) -> np.ndarray:
    """Pad an (N, 6) cloud so that each of n_dev equal shards is a whole
    number of `block` rows (JAX sharding.py:116-125): padding rows sit at a
    far sentinel position with zero moment, so they contribute exactly
    nothing. The port's own shards need no padding; this keeps the JAX
    package's helper for callers that want equal shards."""
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    rem = (-n) % (n_dev * block)
    out = np.concatenate([pts, np.zeros((rem,) + pts.shape[1:], np.float32)])
    out[n:, :3] = _SENTINEL
    return out


# ---------------------------------------------------------------------------
# fields over the mesh
# ---------------------------------------------------------------------------

def field_grad_sharded(sources, targets, mesh: Mesh, eps: float = 1e-5,
                       shard: str = "targets") -> np.ndarray:
    """Dipole field E (T, 3) with the pair space sharded over the mesh (JAX
    sharding.py:60-113): shard="targets" (all sources on every shard, no
    collective), "sources" (partial fields, psum) or "ring". Each shard
    runs fields.field_grad (csrc/field.cu on a card). field.cu plans its
    source chunks from (sources, targets), so a shard may sum in another
    order than one call over everything: the result is held to the field's
    tolerance, not to its bits."""
    one_axis(mesh)
    src = _host(sources, 6)
    tgt = _host(targets, 3)
    if shard == "targets":
        rep = _replicate(src, mesh)
        return _gather([_field(rep[t.device], t, eps) for t in _shards(tgt, mesh)])
    if shard == "sources":
        rep = _replicate(tgt, mesh)
        parts = [_field(s, rep[s.device], eps) for s in _shards(src, mesh)]
        return _psum(parts, mesh.devices[0]).cpu().numpy()
    if shard == "ring":
        return _gather(_ring(_shards(src, mesh), _shards(tgt, mesh), mesh,
                             lambda s, t: _field(s, t, eps)))
    raise ValueError(f"unknown shard mode {shard!r}")


def potential_sharded(sources, targets, mesh: Mesh,
                      shard: str = "sources") -> np.ndarray:
    """Dipole potential (T,) over the mesh (JAX sharding.py:160-207):
    shard="sources" (source shards, all targets on each, psum: the 10^3
    sign-fix lattice) or "ring" (both sharded: a large target cloud). Each
    shard runs fields.potential (csrc/potential.cu on a card); a target on a
    source is scrubbed to 0 within the shard that holds that source."""
    one_axis(mesh)
    src = _host(sources, 6)
    tgt = _host(targets, 3)
    if shard == "sources":
        rep = _replicate(tgt, mesh)
        parts = [_potential(s, rep[s.device]) for s in _shards(src, mesh)]
        return _psum(parts, mesh.devices[0]).cpu().numpy()
    if shard == "ring":
        return _gather(_ring(_shards(src, mesh), _shards(tgt, mesh), mesh,
                             _potential))
    raise ValueError(f"unknown shard mode {shard!r}")


def interaction_accumulate_sharded(pts, signs, mesh: Mesh, eps: float = 1e-5,
                                   shard: str = "ring") -> np.ndarray:
    """acc_i = sum_j sign_j I_ij with the cloud sharded over the mesh (JAX
    sharding.py:210-243): the field of the signed cloud at every point,
    dotted with its normal. shard="ring" keeps O(N / D) of the cloud on a
    shard; "sources" holds all targets on each shard and sums the partial
    fields."""
    one_axis(mesh)
    pts = _host(pts, 6)
    signed = pts.clone()
    signed[:, 3:6] *= as_f32(signs, pts.device)[:, None]
    if shard == "ring":
        E = _gather(_ring(_shards(signed, mesh), _shards(pts[:, :3], mesh), mesh,
                          lambda s, t: _field(s, t, eps)))
    elif shard == "sources":
        rep = _replicate(pts[:, :3], mesh)
        E = _psum([_field(s, rep[s.device], eps) for s in _shards(signed, mesh)],
                  mesh.devices[0]).cpu().numpy()
    else:
        raise ValueError(f"unknown shard mode {shard!r}")
    return (E * pts[:, 3:6].cpu().numpy()).sum(-1)


def point_group_interaction_sharded(pts, group_ids, num_groups: int,
                                    mesh: Mesh, eps: float = 1e-5,
                                    source_weights=None) -> np.ndarray:
    """F[i, g] = sum over sources j of group g of I[i, j] with the TARGET
    rows sharded over the mesh (JAX sharding.py:246-280): every shard takes
    all the sources against its own rows, no collective. Each shard runs
    fields.point_group_interaction(..., targets=) (csrc/group.cu on a card),
    whose grid is planned from the sources alone (their group offsets and
    count), and each target sums its sources in the same order whatever
    rows sit beside it: so the result is bit-equal to the one-device call,
    on the card as on the CPU. source_weights scales every point's moment,
    as a target and as a source (weighted_prop)."""
    one_axis(mesh)
    pts = _host(pts, 6)
    if source_weights is not None:
        pts = pts.clone()
        pts[:, 3:6] *= as_f32(source_weights, pts.device)[:, None]
    gid = torch.as_tensor(np.asarray(group_ids) if not isinstance(group_ids, torch.Tensor)
                          else group_ids).to(torch.int64)
    src = _replicate(pts, mesh)
    ids = _replicate(gid, mesh)
    return _gather([fields.point_group_interaction(src[t.device], ids[t.device],
                                                   num_groups, eps=eps, targets=t)
                    for t in _shards(pts, mesh)])


# ---------------------------------------------------------------------------
# the sequential loops
# ---------------------------------------------------------------------------

def _column(src: torch.Tensor, pos: torch.Tensor, nrm: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Interaction of the source point src (6,) at a target shard (pos,
    nrm): JAX sharding.py:329-343 term for term (-(a - b) written b - a,
    which is exact; the non-finite scrub as nan_to_num)."""
    R = src[:3] - pos
    r2 = (R * R).sum(-1)
    zero = r2 == 0.0
    r = fields.sqrt_rn(r2)
    denom = r * r2 + eps
    p = src[3:6]
    cdot = R @ p
    Rn = (R * nrm).sum(-1)
    pn = nrm @ p
    safe_r2 = torch.where(zero, 1.0, r2)
    col = pn / denom - 3.0 * cdot * Rn / (safe_r2 * denom)
    return torch.where(zero, 0.0, torch.nan_to_num(col, nan=0.0, posinf=0.0,
                                                   neginf=0.0))


def _groups(parts: list) -> list:
    """The non-empty shards grouped by device, in shard order within a
    device: [(device, [(shard, global offset, rows), ...]), ...]. A device
    holding several shards (a virtual mesh, the CPU mesh) runs them as one
    batch: every op of a step is one launch over its shards."""
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    by_dev: dict = {}
    for i, p in enumerate(parts):
        if len(p):
            by_dev.setdefault(p.device, []).append((i, int(offsets[i]), len(p)))
    return list(by_dev.items())


def greedy_sign_sequence_sharded(pts, mesh: Mesh, starting_point: int = 0,
                                 eps: float = 1e-6):
    """The strongest-field greedy with its accumulator sharded over the mesh
    (JAX sharding.py:283-396): each shard owns a slice of the points and
    adds the chosen point's column at its slice. A step takes the masked
    argmax of every shard (its first maximum), moves the candidates (|acc|,
    acc and the point, the global index) to shard 0, picks the winner there
    as the JAX loop does (the largest |acc|, ties to the lowest global
    index), sends the winner's row and sign to every device, and each shard
    marks it visited and adds its column. The shards of one device run as
    a batch, padded to the longest (padding rows stay visited). Exactly
    N - 1 steps, no host read-back during them; the winners and their signs
    stay on shard 0 and are scattered once at the end. The same decisions
    as ops/propagate.greedy_sign_sequence; the column formula is the JAX
    sharded loop's, so acc agrees to rounding (the one-device matrix tier
    reads rows of I instead). Returns (acc, sign) on the host."""
    one_axis(mesh)
    pts = _host(pts, 6)
    n = pts.shape[0]
    if n <= 1:
        return np.zeros(n, np.float32), np.ones(n, np.float32)
    if not 0 <= starting_point < n:
        raise ValueError(f"starting point {starting_point} outside [0, {n})")
    dev0 = mesh.devices[0]
    parts = _shards(pts, mesh)
    groups = []
    for d, members in _groups(parts):
        width = max(m for *_, m in members)
        table = torch.zeros((len(members), width, 7), device=d)  # acc | point
        gidx = torch.full((len(members), width), -1, dtype=torch.int64, device=d)
        for j, (i, base, m) in enumerate(members):
            table[j, :m, 1:] = parts[i]
            gidx[j, :m] = torch.arange(base, base + m, device=d)
        pos, nrm = table[..., 1:4].contiguous(), table[..., 4:7].contiguous()
        table[..., 0] = _column(pts[starting_point].to(d), pos, nrm, eps)
        groups.append((d, d == dev0, table, pos, nrm, gidx,
                       (gidx < 0) | (gidx == starting_point),
                       torch.arange(len(members), device=d)))
    winners = torch.empty(n - 1, dtype=torch.int64, device=dev0)
    signs = torch.empty(n - 1, dtype=torch.float32, device=dev0)
    big = torch.iinfo(torch.int64).max
    for k in range(n - 1):
        vals, rows, idxs = [], [], []
        for d, home, table, _, _, gidx, visited, sr in groups:
            v, li = table[..., 0].abs().masked_fill_(visited, -float("inf")).max(1)
            row, gi = table[sr, li], gidx[sr, li]
            vals.append(v if home else v.to(dev0))
            rows.append(row if home else row.to(dev0))
            idxs.append(gi if home else gi.to(dev0))
        if len(groups) > 1:
            vals, rows, idxs = torch.cat(vals), torch.cat(rows), torch.cat(idxs)
        else:
            vals, rows, idxs = vals[0], rows[0], idxs[0]
        b = torch.where(vals == vals.max(), idxs, big).argmin()
        win, c = rows[b], idxs[b]                    # acc, x y z, nx ny nz
        sgn = torch.where(win[0] < 0, -1.0, 1.0)
        winners[k] = c
        signs[k] = sgn
        for d, home, table, pos, nrm, gidx, visited, _ in groups:
            wd, cd, sd = (win, c, sgn) if home else (win.to(d), c.to(d), sgn.to(d))
            visited |= gidx == cd
            table[..., 0].addcmul_(_column(wd[1:], pos, nrm, eps), sd)
    acc = torch.zeros(n, dtype=torch.float32)
    for d, _, table, _, _, gidx, _, _ in groups:
        keep = gidx >= 0
        acc[gidx[keep].cpu()] = table[..., 0][keep].cpu()
    sign = torch.zeros(n, dtype=torch.float32, device=dev0)
    sign[starting_point] = 1.0
    sign[winners] = signs
    return acc.numpy(), sign.cpu().numpy()


def orient_points_multichip(pts, mesh: Mesh, diffuse: bool = True,
                            starting_point: int = 0, eps: float = 1e-6) -> np.ndarray:
    """orient_simple's core over the mesh (JAX sharding.py:399-419): the
    sharded greedy, the optional diffuse re-vote (keep a sign iff acc *
    sign > 0), and the source-sharded lattice sign fix. Returns a new
    oriented (N, 6) array."""
    pts = np.asarray(pts, np.float32)
    acc, sign = greedy_sign_sequence_sharded(pts, mesh, starting_point, eps)
    if diffuse:
        sign = sign * np.where(acc * sign > 0, 1.0, -1.0).astype(np.float32)
    out = pts.copy()
    out[:, 3:6] *= sign[:, None]
    if potential_sharded(out, gen_grid(10), mesh).mean() < 0:
        out[:, 3:6] *= -1
    return out


def xie_in_order_sharded(pts, orders, mesh: Mesh, C: float = 3.0,
                         eps: float = 1e-6, diffuse: bool = False,
                         kernel: str = "xie") -> np.ndarray:
    """The order replay with the interaction matrix COLUMN-sharded over the
    mesh (JAX sharding.py:422-509): shard d builds only its block I[:, cols
    of d] (N, N_d) — fields.xie_interaction_matrix(shard, targets=pts), or
    the dipole matrix with its eps pinned at 1e-6 whatever `eps` says, as
    the one-device replay does (csrc/imatrix.cu's general modes on a
    card). Each step every shard sums its columns of the T visited rows
    against its weights in float64, the partials are summed in shard order
    on shard 0 (psum), and the owner of each visited column records its
    sign. `diffuse` re-votes every point by w @ I^T: one partial (T, N) a
    shard and one psum. Exactly the orders' steps; no host read-back
    during them. Returns the (T, N) bool flip mask, as
    ops/propagate.xie_propagation_in_order: the sums are associated per
    shard, so a near-zero interaction may decide otherwise than the
    one-device row sum; compare by agreement."""
    one_axis(mesh)
    if kernel not in ("xie", "dipole"):
        raise ValueError(f"unknown kernel {kernel!r}")
    pts = _host(pts, 6)
    n = pts.shape[0]
    orders = np.asarray(orders, dtype=np.int64)
    if orders.ndim != 2 or orders.shape[1] > n or (
            orders.size and (orders.min() < 0 or orders.max() >= n)):
        raise ValueError(f"orders: expected (T, <= {n}) indices in [0, {n})")
    T, steps = orders.shape
    dev0 = mesh.devices[0]
    rep = _replicate(pts, mesh)
    parts = _shards(pts, mesh)
    rows = torch.as_tensor(orders.T.copy())                       # (steps, T)
    groups, order = [], []
    for d, members in _groups(parts):
        width = max(m for *_, m in members)
        # the shards' column blocks, padded with zero columns to the widest
        block = torch.zeros((len(members), n, width), device=d)
        cols = np.empty((len(members), steps, T), np.int64)
        for j, (i, base, m) in enumerate(members):
            if kernel == "xie":
                block[j, :, :m] = fields.xie_interaction_matrix(parts[i], C=C, targets=rep[d])
            else:
                block[j, :, :m] = fields.dipole_interaction_matrix(parts[i], eps=1e-6,
                                                                   targets=rep[d])
            # each order's column here, or the unread column `width` when
            # the visited point lies on another shard
            local = orders.T - base
            cols[j] = np.where((local >= 0) & (local < m), local, width)
            order.append((i, len(groups), j, m))
        groups.append((d, block, rows.to(d), torch.as_tensor(cols, device=d),
                       torch.zeros((len(members), T, width + 1), device=d),
                       torch.arange(len(members), device=d)[:, None],
                       torch.arange(T, device=d)[None, :]))
    order = [(g, j, m) for _, g, j, m in sorted(order)]           # shard order
    for k in range(steps):
        # w is 0 or +-1, so each product is exact; the sums are float64
        sums = [(block.index_select(1, r[k]) * w[..., :-1]).sum(-1, dtype=torch.float64)
                for _, block, r, _, w, _, _ in groups]
        sgn = torch.where(_psum([sums[g][j] for g, j, _ in order], dev0) < 0, -1.0, 1.0)
        for d, _, _, cols, w, sr, rg in groups:
            w[sr, rg, cols[:, k]] = sgn if d == dev0 else sgn.to(d)
    if diffuse:
        rec = _psum([groups[g][4][j, :, :-1] @ groups[g][1][j].t()
                     for g, j, _ in order], dev0)
        return (rec < 0).cpu().numpy()
    # a recorded interaction is < 0 exactly where its sign is -1
    return torch.cat([(groups[g][4][j, :, :m] < 0).cpu() for g, j, m in order],
                     dim=1).numpy()
