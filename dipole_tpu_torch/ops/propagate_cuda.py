"""Wrapper of the greedy kernel `csrc/greedy.cu`, which replaces
dipole_tpu/ops/propagate_pallas.py's three Pallas greedy kernels
(_greedy_kernel, _greedy_streamed_kernel, _greedy_xl_kernel) with one
cooperative CUDA kernel, in three update modes of one design (owner state
in registers, one exchanged 8-byte word a step):

  greedy_rows     the matrix tier: reads row c of a precomputed (N, N) I;
  greedy_columns  the on-the-fly tier: computes column c from the cloud;
  xie_greedy      the mirror-field loop (replaces the XLA scan
                  propagate.py:_xie_greedy_scan): reads row c of the
                  transposed xie matrix, with an optional kNN mask in index
                  form;

and of `csrc/replay.cu`, the in-order replay (replaces the XLA scan
propagate.py:_in_order_scan): T orders in lock-step over one matrix, blocked
over 128 steps (a bulk pass over all the SMs, then 128 decisions per order
in one warp).

The wrappers take CUDA tensors only (the plain versions and the CPU dispatch
live in ops/propagate.py), allocate outputs and scratch with torch.empty
(the greedy's exchange words with torch.zeros, for every launch), launch on the
current stream, raise on a CUDA error and count launches in LAUNCHES.
Greedy kernels and plain versions agree bit for bit in acc and sign (the
kernel is built with -fmad=false; see the note in csrc/greedy.cu); the
replay and its plain version take the same decisions (float64 sums in two
orders; see csrc/replay.cu).

The greedy wrappers' arguments that start with an underscore choose the
launch for tests and measurements (chip_smoke.py); no user path passes them.
"""
from __future__ import annotations

import ctypes

import torch

from dipole_tpu_torch.ops import _build
from dipole_tpu_torch.ops.fields_cuda import check_tensor

__all__ = ["greedy_rows", "greedy_columns", "xie_greedy", "replay",
           "reverse_knn", "LAUNCHES", "last_launch",
           "one_block_max_n"]

LAUNCHES = {"greedy_rows": 0, "greedy_columns": 0, "greedy_xie": 0, "replay": 0}
_CAPACITY = 1024        # exchange words per parity; the grid never exceeds it
MAX_POINTS = 2**24      # the greedy key's index field (csrc/greedy.cu)
MAX_XIE_K = 256         # the xie mode's kNN mask width (csrc/greedy.cu)
_MODES = {"columns": 0, "rows": 1, "xie": 2}   # csrc/greedy.cu's Mode
_P_, _N_ = ctypes.c_void_p, ctypes.c_int
_last = {"blocks": 0}


def last_launch() -> dict:
    """The latest greedy or replay launch: blocks (for the replay, the
    orders: one block each decides), and for the greedy the points a thread
    holds in registers (0: its state in global memory)."""
    return dict(_last)


def one_block_max_n(mode: str) -> int:
    """The most points the greedy runs on one block in `mode` ("rows",
    "columns" or "xie")."""
    _, fn = _build.entry("greedy", "dipole_greedy_one_block_max_n", [_N_])
    return fn(_MODES[mode])


def _check_points(n: int) -> None:
    if n > MAX_POINTS:
        raise ValueError(f"{n} points: the greedy kernel takes at most 2^24")


def _launch(data: torch.Tensor, n: int, start: int, eps: float, mode: str,
            reg_cap: int, blocks: int, knn: torch.Tensor | None = None):
    if not 0 <= start < n:
        raise ValueError(f"starting point {start} outside [0, {n})")
    lib, fn = _build.entry("greedy", "dipole_greedy",
                           [_P_, _N_, _N_, ctypes.c_float, _N_, _P_, _N_, _P_, _P_,
                            _P_, _N_, _N_, _N_, ctypes.POINTER(ctypes.c_int), _P_])
    dev = data.device
    acc = torch.empty(n, dtype=torch.float32, device=dev)
    sign = torch.empty(n, dtype=torch.float32, device=dev)
    # one 8-byte candidate a block and step parity, zero on entry
    slots = torch.zeros(2 * _CAPACITY, dtype=torch.int64, device=dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), n, int(start), float(eps), _MODES[mode],
                 0 if knn is None else knn.data_ptr(),
                 0 if knn is None else knn.shape[1],
                 acc.data_ptr(), sign.data_ptr(), slots.data_ptr(), _CAPACITY,
                 int(reg_cap), int(blocks), info, stream)
    _build.check(lib, err, "dipole_greedy")
    LAUNCHES["greedy_xie" if mode == "xie" else f"greedy_{mode}"] += 1
    _last.clear()
    _last.update(blocks=info[0], per_thread=info[1])
    return acc, sign


def greedy_rows(I: torch.Tensor, start: int, *, _reg_cap: int = 0, _blocks: int = 0):
    """(acc, sign) of the greedy over a precomputed (N, N) interaction
    matrix (N <= 2^24), reading row c at each step. _reg_cap (state in
    global memory above this many points; 0: only above what the SMs hold)
    and _blocks (0: the kernel's choice) are for tests and measurements."""
    _check_points(I.shape[0])
    check_tensor(I, "I")
    if I.shape[0] != I.shape[1]:
        raise ValueError(f"I: expected a square matrix, got {tuple(I.shape)}")
    return _launch(I, I.shape[0], start, 0.0, "rows", _reg_cap, _blocks)


def greedy_columns(pts: torch.Tensor, start: int, eps: float, *, _reg_cap: int = 0,
                   _blocks: int = 0):
    """(acc, sign) of the greedy over an (N, 6) cloud (N <= 2^24), computing
    each step's interaction column on the fly; the private arguments as
    greedy_rows'."""
    _check_points(pts.shape[0])
    check_tensor(pts, "pts", 6)
    planes = pts.t().contiguous()      # (6, N) channel-major for coalescing
    return _launch(planes, pts.shape[0], start, eps, "columns", _reg_cap, _blocks)


def _check_knn(knn_idx: torch.Tensor | None, n: int, device) -> None:
    if knn_idx is None:
        return
    if (not isinstance(knn_idx, torch.Tensor) or knn_idx.device != device
            or knn_idx.dim() != 2 or knn_idx.shape[0] != n):
        raise ValueError("knn_idx: expected an (N, k) index tensor on the "
                         "matrix's device")


def xie_greedy(IT: torch.Tensor, start: int, knn_idx: torch.Tensor | None = None,
               *, _blocks: int = 0):
    """(acc, sign) of the sequential xie loop over the transposed (N, N) xie
    matrix IT (row c is column c of I), from `start`; knn_idx (N, k): the
    kNN mask in index form (row j: the targets kept for source j). Its
    state stays in registers: the kernel refuses more than 8192 points an
    SM. _blocks (0: the kernel's choice) is for tests and measurements."""
    check_tensor(IT, "IT")
    n = IT.shape[0]
    if IT.shape[1] != n:
        raise ValueError(f"IT: expected a square matrix, got {tuple(IT.shape)}")
    if not 0 <= start < n:
        raise ValueError(f"starting point {start} outside [0, {n})")
    _check_knn(knn_idx, n, IT.device)
    k = 0 if knn_idx is None else knn_idx.shape[1]
    if k > MAX_XIE_K:
        raise ValueError(f"knn mask of {k} neighbours: the kernel takes at most "
                         f"{MAX_XIE_K}")
    knn = None if not k else knn_idx.to(torch.int32).contiguous()
    return _launch(IT, n, start, 0.0, "xie", 0, _blocks, knn)


def reverse_knn(knn_idx: torch.Tensor, n: int):
    """(rev_ptr (N + 1,), rev_src) int32: for each target i the sources j
    with i in knn_idx[j], ascending and each once — the kNN mask's rows.
    Entries outside [0, N) select nothing."""
    k = knn_idx.shape[1]
    tgt = knn_idx.reshape(-1).to(torch.int64)
    src = torch.arange(n, device=knn_idx.device).repeat_interleave(k)
    ok = (tgt >= 0) & (tgt < n)
    keys = torch.unique(tgt[ok] * n + src[ok])          # sorted: target, source
    counts = torch.bincount(keys // n, minlength=n)
    rev_ptr = torch.zeros(n + 1, dtype=torch.int32, device=knn_idx.device)
    rev_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return rev_ptr, (keys % n).to(torch.int32).contiguous()


def replay(I: torch.Tensor, orders: torch.Tensor,
           knn_idx: torch.Tensor | None = None,
           colw: torch.Tensor | None = None):
    """(w (T, N) float32, inter (T, N) float64) of the in-order replay of
    orders (T, S) over the (N, N) matrix I (rows read); knn_idx (N, k): the
    kNN mask in index form; colw (N,): per-source column weights. An index
    may repeat in an order (a later visit overwrites). Unmasked, the replay
    runs in blocks of 128 steps; masked, one warp per order."""
    check_tensor(I, "I")
    n = I.shape[0]
    if I.shape[1] != n:
        raise ValueError(f"I: expected a square matrix, got {tuple(I.shape)}")
    dev = I.device
    if (not isinstance(orders, torch.Tensor) or orders.device != dev
            or orders.dim() != 2):
        raise ValueError("orders: expected a (T, S) index tensor on the matrix's device")
    T, steps = orders.shape
    if steps > 0 and (int(orders.min()) < 0 or int(orders.max()) >= n):
        raise ValueError(f"orders: indices outside [0, {n})")
    _check_knn(knn_idx, n, dev)
    if colw is not None:
        check_tensor(colw, "colw", ndim=1)
        if colw.shape[0] != n or colw.device != dev:
            raise ValueError("colw: expected (N,) on the matrix's device")
    lib, fn = _build.entry("replay", "dipole_replay",
                           [_P_, _N_, _P_, _N_, _N_, _P_, _P_, _P_, _P_, _P_,
                            _P_, _P_, _P_])
    rev_ptr = rev_src = part = tri = None
    if knn_idx is not None:
        rev_ptr, rev_src = reverse_knn(knn_idx, n)
    else:
        _, scratch = _build.entry("replay", "dipole_replay_scratch", [_N_, _P_, _P_])
        sizes = (ctypes.c_longlong(), ctypes.c_longlong())
        scratch(T, ctypes.byref(sizes[0]), ctypes.byref(sizes[1]))
        part = torch.empty(sizes[0].value, dtype=torch.float64, device=dev)
        tri = torch.empty(sizes[1].value, dtype=torch.float32, device=dev)
    o = orders.to(torch.int32).contiguous()
    w = torch.zeros((T, n), dtype=torch.float32, device=dev)
    inter = torch.zeros((T, n), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(I.data_ptr(), n, o.data_ptr(), T, steps,
                 0 if colw is None else colw.data_ptr(),
                 0 if rev_ptr is None else rev_ptr.data_ptr(),
                 0 if rev_src is None else rev_src.data_ptr(),
                 0 if part is None else part.data_ptr(),
                 0 if tri is None else tri.data_ptr(),
                 w.data_ptr(), inter.data_ptr(), stream)
    _build.check(lib, err, "dipole_replay")
    LAUNCHES["replay"] += 1
    _last.clear()
    _last.update(blocks=T)
    return w, inter
