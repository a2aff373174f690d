"""Wrappers of the field kernels: `csrc/potential.cu` (replaces
dipole_tpu/ops/fields_pallas.py:_potential_kernel), `csrc/imatrix.cu`
(fields_pallas.py:_dipole_imatrix_kernel and, as xie_imatrix,
_xie_imatrix_kernel), `csrc/field.cu`
(fields_pallas.py:_field_kernel), `csrc/group.cu`
(fields_pallas.py:_group_kernel) and `csrc/field_mma.cu`
(tools/mxu_field_experiment.py:_field_kernel_mxu_exact and
_field_kernel_mxu_expansion, the field with its sums on the tensor cores).

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with torch.empty, launches on the current
stream, raises when the launch returns a CUDA error, and adds one to its
count in LAUNCHES. The plain torch versions (and the CPU dispatch) live in
ops/fields.py (of the tensor-core variants, in
tools/mxu_field_experiment.py).
"""
from __future__ import annotations

import ctypes

import torch

from dipole_tpu_torch.ops import _build

__all__ = ["potential", "dipole_imatrix", "xie_imatrix", "field_grad",
           "point_group", "group_chunks", "GROUP_CHUNK", "matrix_out",
           "field_mxu_exact", "field_mxu_expansion", "LAUNCHES"]

LAUNCHES = {"dipole_potential": 0, "dipole_imatrix": 0, "dipole_field": 0,
            "dipole_group": 0, "xie_imatrix": 0, "field_mxu_exact": 0,
            "field_mxu_expansion": 0}

_P = ctypes.c_void_p
_N = ctypes.c_int


def check_tensor(t: torch.Tensor, name: str, cols: int | None = None,
                 ndim: int = 2) -> None:
    """Raise unless t is a contiguous float32 CUDA tensor of the shape."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim or (cols is not None and t.shape[-1] != cols):
        raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.shape[0] >= 2**31:
        raise ValueError(f"{name}: more than 2^31 - 1 rows")


def potential(sources: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """phi (T,) at targets (T, 3) from dipole sources (M, 6), non-finite
    totals scrubbed to 0 — on the card, by csrc/potential.cu, which is bound
    by instruction issue: the field's design (4 targets a thread, the
    sources staged in shared memory, source chunks that fill the card) with
    one approximate reciprocal square root a pair, ~14 issued instructions
    (0.106 ms at the sign fix's 1000 x 180000 on an H100, 43% of the bound;
    0.356 with IEEE roots, one target a thread). It is held to the plain
    version within 1e-4 |phi| + 1e-5 max|phi| per target (the worst at
    0.0026 of that there). A target on a source stays poisoned (0/0) until
    its total is scrubbed to 0. The partial sums of the chunks (scratch of
    dipole_potential_chunks(M, T) x T floats, none for a single chunk) are
    added in a fixed order: no atomics."""
    check_tensor(sources, "sources", 6)
    check_tensor(targets, "targets", 3)
    if sources.device != targets.device:
        raise ValueError("sources and targets on different devices")
    lib, chunks = _build.entry("potential", "dipole_potential_chunks", [_N, _N])
    _, fn = _build.entry("potential", "dipole_potential", [_P, _N, _P, _N, _P, _P, _P])
    m, t = sources.shape[0], targets.shape[0]
    out = torch.empty(t, dtype=torch.float32, device=sources.device)
    partial = torch.empty(chunks(m, t) * t, dtype=torch.float32,
                          device=sources.device)
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sources.data_ptr(), m, targets.data_ptr(), t,
                 partial.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, "dipole_potential")
    _build.bump(LAUNCHES, "dipole_potential")
    return out


def matrix_out(rows: int, cols: int, device, what: str) -> torch.Tensor:
    """An empty (rows, cols) float32 matrix on `device`; a MemoryError that
    names the size when the card cannot hold it, raised by the allocation,
    before any kernel runs."""
    try:
        return torch.empty((rows, cols), dtype=torch.float32, device=device)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(
            f"{what}: a {rows} x {cols} float32 matrix needs "
            f"{4 * rows * cols / 1e9:.2f} GB, more than the card can hold "
            f"({e})") from e


def dipole_imatrix(targets: torch.Tensor, sources: torch.Tensor,
                   eps: float, symmetric: bool = False) -> torch.Tensor:
    """I (T, M), I[i, j] = E_j(x_i) . n_i, from targets (T, 6) and sources
    (M, 6) — on the card, by csrc/imatrix.cu's dipole_imatrix, bit-equal to
    the plain version. symmetric: the targets are the sources (the caller's
    word; the points are not compared). The kernel then takes the terms of
    each pair (i, j) once (one IEEE root, three IEEE divides) and writes
    I[i, j] = -((3 c) Rn / D - pn / denom) and, by an identity exact in
    float32, the mirror I[j, i] = -((3 Rn) c / D - pn / denom): ~52 issued
    instructions an entry, 0.218 ms at 10000^2 on an H100 (0.326 one entry
    a thread; the general mode, 0.287). Either way the kernel is held by
    instruction issue, not by the T x M x 4 bytes it writes; tiles of 32
    instead of 64 fill the card at graph_dipole's few hundred points."""
    check_tensor(targets, "targets", 6)
    check_tensor(sources, "sources", 6)
    if sources.device != targets.device:
        raise ValueError("sources and targets on different devices")
    if symmetric and targets.shape != sources.shape:
        raise ValueError("symmetric: the targets must be the sources")
    lib, fn = _build.entry("imatrix", "dipole_imatrix",
                           [_P, _N, _P, _N, ctypes.c_float, _N, _P, _P])
    t, m = targets.shape[0], sources.shape[0]
    out = matrix_out(t, m, sources.device, "dipole_imatrix")
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(targets.data_ptr(), t, sources.data_ptr(), m, float(eps),
                 int(symmetric), out.data_ptr(), stream)
    _build.check(lib, err, "dipole_imatrix")
    _build.bump(LAUNCHES, "dipole_imatrix")
    return out


def xie_imatrix(targets: torch.Tensor, sources: torch.Tensor, C: float,
                transposed: bool = False, symmetric: bool = False) -> torch.Tensor:
    """The xie matrix I (T, M) of targets (T, 6) and sources (M, 6), or I^T
    (M, T) with the same bits when transposed — on the card, by
    csrc/imatrix.cu's xie_imatrix, bit-equal to the plain version in both
    layouts. symmetric: the targets are the sources (the caller's word; the
    points are not compared). The kernel then takes the terms of each pair
    (i, j) once and writes I[i, j] = (nn - (C nsR) ntR) / r3 and, by an
    identity exact in float32, the mirror I[j, i] = (nn - (C ntR) nsR) /
    r3: ~47 issued instructions an entry instead of ~69. Either way the
    kernel is held by instruction issue (IEEE roots and divides), not by
    the N^2 x 4 bytes it writes."""
    check_tensor(targets, "targets", 6)
    check_tensor(sources, "sources", 6)
    if sources.device != targets.device:
        raise ValueError("sources and targets on different devices")
    if symmetric and targets.shape != sources.shape:
        raise ValueError("symmetric: the targets must be the sources")
    lib, fn = _build.entry("imatrix", "xie_imatrix",
                           [_P, _N, _P, _N, ctypes.c_float, _N, _N, _P, _P])
    t, m = targets.shape[0], sources.shape[0]
    out = matrix_out(m, t, sources.device, "xie_imatrix") if transposed \
        else matrix_out(t, m, sources.device, "xie_imatrix")
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(targets.data_ptr(), t, sources.data_ptr(), m, float(C),
                 int(transposed), int(symmetric), out.data_ptr(), stream)
    _build.check(lib, err, "xie_imatrix")
    _build.bump(LAUNCHES, "xie_imatrix")
    return out


def field_grad(sources: torch.Tensor, targets: torch.Tensor,
               eps: float) -> torch.Tensor:
    """E (T, 3) at targets (T, 3) from dipole sources (M, 6), non-finite
    components scrubbed to 0 — on the card, by csrc/field.cu, which is
    bound by instruction issue: 4 targets a thread, the sources staged in
    shared memory, the one-reciprocal pair formula with the hardware's
    approximate root and reciprocal. It is held to the plain version within
    1e-4 |E| + 1e-5 max|E| per component; at the lion's rest-point shape
    (138869 x 41131) its worst component sits at 0.17 of that, as with
    IEEE-rounded roots (the sums' order, not the roots). The source axis
    is cut into chunks that fill the card; their partial fields (scratch
    of dipole_field_chunks(M, T) x T x 3 floats, none for a single chunk)
    are added in order: no atomics."""
    check_tensor(sources, "sources", 6)
    check_tensor(targets, "targets", 3)
    if sources.device != targets.device:
        raise ValueError("sources and targets on different devices")
    lib, chunks = _build.entry("field", "dipole_field_chunks", [_N, _N])
    _, fn = _build.entry("field", "dipole_field",
                   [_P, _N, _P, _N, ctypes.c_float, _P, _P, _P])
    m, t = sources.shape[0], targets.shape[0]
    out = torch.empty((t, 3), dtype=torch.float32, device=sources.device)
    partial = torch.empty(chunks(m, t) * t * 3, dtype=torch.float32,
                          device=sources.device)
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sources.data_ptr(), m, targets.data_ptr(), t, float(eps),
                 partial.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, "dipole_field")
    _build.bump(LAUNCHES, "dipole_field")
    return out


GROUP_CHUNK = 256   # sources a chunk of csrc/group.cu's grid, cut at group starts


def group_chunks(offsets: torch.Tensor, n_max: int) -> torch.Tensor:
    """The chunks of the group kernel's grid: (n_chunks + 1,) int32 on the
    offsets' device, chunk c summing groups [out[c], out[c + 1]), with
    n_chunks = ceil(n_max / GROUP_CHUNK) for n_max >= offsets[-1] (the
    point count: the source count itself would have to be read back from
    the card). offsets (G + 1,) are the group-sorted sources' group offsets.
    With K = GROUP_CHUNK, chunk c owns the groups that start in
    [c K, (c + 1) K), the last chunk also those that start later (empty
    ones at the end), so every group lies in exactly one chunk, whole, and
    a block sums it in index order. At least one chunk."""
    n_groups = offsets.shape[0] - 1
    n_chunks = max(1, -(-n_max // GROUP_CHUNK))
    starts = torch.arange(n_chunks, device=offsets.device,
                          dtype=offsets.dtype) * GROUP_CHUNK
    first = torch.searchsorted(offsets[:-1].contiguous(), starts)
    return torch.cat([first, first.new_full((1,), n_groups)]).to(torch.int32)


def point_group(pts: torch.Tensor, group_ids: torch.Tensor, num_groups: int,
                eps: float, targets: torch.Tensor | None = None) -> torch.Tensor:
    """F (T, G), F[i, g] = sum over j with group_ids[j] == g of I[i, j], from
    source points (N, 6), which are the targets too unless targets (T, 6)
    are given; ids outside [0, G) contribute nowhere — on the card, by
    csrc/group.cu. The grid's chunks are planned from the sources alone, and
    a thread's targets each sum in source order, so a row of F does not
    depend on the other targets of the call (a target shard gives the bits
    of the whole call). The kernel writes F transposed; the result is the
    (T, G) view of that (G, T) buffer."""
    check_tensor(pts, "pts", 6)
    tgt = pts if targets is None else targets
    check_tensor(tgt, "targets", 6)
    if tgt.device != pts.device:
        raise ValueError("targets and sources on different devices")
    if (not isinstance(group_ids, torch.Tensor) or group_ids.device != pts.device
            or group_ids.shape != pts.shape[:1]):
        raise ValueError("group_ids: expected one id per point, on the "
                         "points' device")
    if not 0 < num_groups < 2**31:
        raise ValueError(f"num_groups {num_groups} out of range")
    lib, fn = _build.entry("group", "dipole_group",
                           [_P, _N, _P, _P, _N, _P, _N, ctypes.c_float, _P, _P])
    n, n_t = pts.shape[0], tgt.shape[0]
    # sources sorted by group, stable (each group in index order), ids
    # outside [0, G) last; nothing is read back from the card
    gid = group_ids.to(torch.int64)
    key = torch.where((gid >= 0) & (gid < num_groups), gid, num_groups)
    key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        key, torch.arange(num_groups + 1, device=pts.device)).to(torch.int32)
    chunks = group_chunks(offsets, n)
    src = pts[order]
    out_t = torch.empty((num_groups, n_t), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tgt.data_ptr(), n_t, src.data_ptr(), offsets.data_ptr(),
                 num_groups, chunks.data_ptr(), chunks.shape[0] - 1,
                 float(eps), out_t.data_ptr(), stream)
    _build.check(lib, err, "dipole_group")
    _build.bump(LAUNCHES, "dipole_group")
    return out_t.t()


def _field_mma(name: str, sources: torch.Tensor, targets: torch.Tensor,
               eps: float) -> torch.Tensor:
    check_tensor(sources, "sources", 6)
    check_tensor(targets, "targets", 3)
    if sources.device != targets.device:
        raise ValueError("sources and targets on different devices")
    lib, chunks = _build.entry("field_mma", "dipole_field_mma_chunks", [_N, _N])
    _, fn = _build.entry("field_mma", f"dipole_{name}",
                         [_P, _N, _P, _N, ctypes.c_float, _P, _P, _P])
    m, t = sources.shape[0], targets.shape[0]
    out = torch.empty((t, 3), dtype=torch.float32, device=sources.device)
    partial = torch.empty(chunks(m, t) * t * 3, dtype=torch.float32,
                          device=sources.device)
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sources.data_ptr(), m, targets.data_ptr(), t, float(eps),
                 partial.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, f"dipole_{name}")
    _build.bump(LAUNCHES, name)
    return out


def field_mxu_exact(sources: torch.Tensor, targets: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """E (T, 3) at targets (T, 3) from dipole sources (M, 6), the pair math
    as csrc/field.cu and the sums as 3xTF32 tensor-core products
    (mma.sync), not scrubbed — on the card, by csrc/field_mma.cu. The
    source axis is cut into chunks that fill the card; their partial
    fields (scratch of dipole_field_mma_chunks(M, T) x T x 3 floats, none
    for a single chunk) are added in order: no atomics."""
    return _field_mma("field_mxu_exact", sources, targets, eps)


def field_mxu_expansion(sources: torch.Tensor, targets: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """As field_mxu_exact, with r^2 and p.R from the expansion t.t + s.s -
    2 t.s and p.s - t.p, t.s and t.p on the tensor cores too — on the card,
    by csrc/field_mma.cu."""
    return _field_mma("field_mxu_expansion", sources, targets, eps)
