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
in one warp); masked, one warp per order.

Behind the server's micro-batching, both take B clouds in one launch
(replacing the vmapped XLA scans propagate.py:_greedy_scan_onthefly_vmapped
and _in_order_scan_vmapped): greedy_columns_batched runs the column greedy
of every cloud side by side on its own blocks (greedy_batch_plan cuts the
SMs), replay_batched replays every cloud's orders over its own matrix in
one blocked loop. Each lane is bit-equal to the launch over its cloud alone.

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

Handler threads of the server launch kernels concurrently: LAUNCHES and the
record of last_launch() are updated under _build.COUNT_LOCK, the lock of
every launch and plain-call counter of the package, so the totals are exact;
last_launch() is the latest launch of the process, from whichever thread.
"""
from __future__ import annotations

import ctypes

import torch

from dipole_tpu_torch.ops import _build
from dipole_tpu_torch.ops.fields_cuda import check_tensor

__all__ = ["greedy_rows", "greedy_columns", "greedy_columns_batched",
           "greedy_batch_plan", "xie_greedy", "replay", "replay_batched",
           "reverse_knn", "LAUNCHES", "last_launch", "one_block_max_n"]

LAUNCHES = {"greedy_rows": 0, "greedy_columns": 0, "greedy_xie": 0, "replay": 0,
            "greedy_columns_batched": 0, "replay_batched": 0}
_CAPACITY = 1024        # exchange words per parity; the grid never exceeds it
MAX_POINTS = 2**24      # the greedy key's index field (csrc/greedy.cu)
MAX_XIE_K = 256         # the xie mode's kNN mask width (csrc/greedy.cu)
POINTS_PER_SM = 8192    # csrc/greedy.cu's kPointsPerSM: a block's register state
_THREADS = 1024         # csrc/greedy.cu's kThreads
_MODES = {"columns": 0, "rows": 1, "xie": 2}   # csrc/greedy.cu's Mode
_P_, _N_ = ctypes.c_void_p, ctypes.c_int
_INTS = ctypes.POINTER(ctypes.c_int)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_last = {"blocks": 0}


def _count(name: str, **launch) -> None:
    with _build.COUNT_LOCK:
        LAUNCHES[name] += 1
        _last.clear()
        _last.update(launch)


def last_launch() -> dict:
    """The latest greedy or replay launch of the process: blocks (for the
    replay, the orders: one block each decides), and for the greedy the
    points a thread holds in registers (0: its state in global memory); for
    a batched call, the launches it made."""
    with _build.COUNT_LOCK:
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
    _count("greedy_xie" if mode == "xie" else f"greedy_{mode}",
           blocks=info[0], per_thread=info[1])
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


def greedy_batch_plan(sizes, sms: int, one_block_max_n: int = 4096,
                      max_clouds: int = 128):
    """The launches of a batched column greedy over clouds of `sizes`
    points on `sms` SMs: a list of (clouds, blocks, per), clouds the indices
    of a launch's clouds in order, blocks the blocks of each, per the points
    a thread of the launch. A cloud of up to one_block_max_n points takes
    one block; a larger one at least ceil(n / 8192) (its state in
    registers), at most the single launch's grid (one block a 1024 points,
    up to the SMs), and in between its share of the SMs in proportion to the
    launch's points. Clouds go into a launch in order while their least
    blocks fit on the SMs, at most max_clouds (csrc/greedy.cu's
    kMaxClouds). Raises for a cloud whose state does not fit in the SMs'
    registers (more than sms x 8192 points)."""
    need = []
    for i, n in enumerate(sizes):
        if n > sms * POINTS_PER_SM:
            raise ValueError(
                f"cloud {i} of {n} points: the batched greedy keeps every "
                f"point in registers, at most {sms * POINTS_PER_SM} points on "
                f"{sms} SMs; orient it alone (greedy_sign_sequence)")
        need.append(1 if n <= one_block_max_n else -(-n // POINTS_PER_SM))
    groups, cur = [], []
    for i, g in enumerate(need):
        if cur and (sum(need[j] for j in cur) + g > sms or len(cur) == max_clouds):
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)
    plan = []
    for clouds in groups:
        total = sum(sizes[i] for i in clouds)
        blocks = [1 if sizes[i] <= one_block_max_n else
                  max(need[i], min(-(-sizes[i] // _THREADS), sms,
                                   sms * sizes[i] // total))
                  for i in clouds]
        while sum(blocks) > sms:       # give back from the widest grid first
            k = max((b for b in range(len(clouds)) if blocks[b] > need[clouds[b]]),
                    key=lambda b: blocks[b])
            blocks[k] -= 1
        per = 1
        for i, g in zip(clouds, blocks):
            while per * g * _THREADS < sizes[i]:
                per *= 2
        plan.append((clouds, blocks, per))
    return plan


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def greedy_columns_batched(pts_list, starts, eps: float, *, _sms: int = 0):
    """[(acc, sign)] of the column greedy over each (N_b, 6) cloud of
    pts_list from starts[b], in as few cooperative launches as the SMs allow
    (greedy_batch_plan): each lane bit-equal to greedy_columns on its cloud
    alone, ties included. Every cloud's state stays in registers, so a cloud
    above the SMs x 8192 points is refused. _sms (plan for fewer SMs than
    the card has: more launches) is for tests and measurements."""
    if len(starts) != len(pts_list):
        raise ValueError(f"{len(pts_list)} clouds but {len(starts)} starts")
    if not pts_list:
        return []
    dev = pts_list[0].device
    sizes = []
    for b, (pts, start) in enumerate(zip(pts_list, starts)):
        check_tensor(pts, f"pts_list[{b}]", 6)
        if pts.device != dev:
            raise ValueError(f"pts_list[{b}]: on {pts.device}, not {dev}")
        if not 0 <= start < pts.shape[0]:
            raise ValueError(f"cloud {b}: starting point {start} outside "
                             f"[0, {pts.shape[0]})")
        sizes.append(pts.shape[0])
    sms = _sm_count(dev)
    if _sms:
        sms = min(sms, _sms)
    _, most = _build.entry("greedy", "dipole_greedy_batched_max_clouds", [])
    plan = greedy_batch_plan(sizes, sms, one_block_max_n("columns"), most())
    lib, fn = _build.entry("greedy", "dipole_greedy_batched",
                           [_P_, _N_, _INTS, _INTS, _INTS, _INTS, _N_, _N_,
                            ctypes.c_float, _P_, _P_, _P_, _N_, _P_])
    planes = torch.cat([p.t() for p in pts_list], dim=1).contiguous()   # (6, sum N)
    total = planes.shape[1]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + n)
    acc = torch.empty(total, dtype=torch.float32, device=dev)
    sign = torch.empty(total, dtype=torch.float32, device=dev)
    launches = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for clouds, blocks, per in plan:
            slots = torch.zeros(2 * _CAPACITY, dtype=torch.int64, device=dev)
            err = fn(planes.data_ptr(), total, _ints([offs[i] for i in clouds]),
                     _ints([sizes[i] for i in clouds]),
                     _ints([int(starts[i]) for i in clouds]), _ints(blocks),
                     len(clouds), per, float(eps), acc.data_ptr(), sign.data_ptr(),
                     slots.data_ptr(), _CAPACITY, stream)
            _build.check(lib, err, "dipole_greedy_batched")
            launches.append({"clouds": len(clouds), "blocks": sum(blocks),
                             "per_thread": per})
            _count("greedy_columns_batched", launches=list(launches))
    return [(acc[o:o + n], sign[o:o + n]) for o, n in zip(offs, sizes)]


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
    may repeat in an order (a later visit overwrites). Unmasked, the orders
    are lanes of replay_batched's blocked loop (128 steps a block); masked,
    one warp per order."""
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
    _count("replay", blocks=T)
    return w, inter


def replay_batched(I_list, orders_list):
    """[(w (T_b, N_b) float32, inter (T_b, N_b) float64)] of the unmasked,
    unweighted in-order replay of each cloud's orders (T_b, S_b) over its
    (N_b, N_b) matrix, all clouds in one call (a lane an order; csrc/replay.cu
    runs 48 lanes in one blocked loop, more lanes in more loops). Each
    lane's w and inter are bit-equal to replay on its cloud alone; orders of
    different lengths end where they end."""
    if len(I_list) != len(orders_list):
        raise ValueError(f"{len(I_list)} matrices but {len(orders_list)} order sets")
    if not I_list:
        return []
    dev = I_list[0].device
    out, lanes = [], []
    keep = []     # the int32 orders, alive until the call below is enqueued
    for b, (I, orders) in enumerate(zip(I_list, orders_list)):
        check_tensor(I, f"I_list[{b}]")
        n = I.shape[0]
        if I.shape[1] != n or I.device != dev:
            raise ValueError(f"I_list[{b}]: expected a square matrix on {dev}")
        if (not isinstance(orders, torch.Tensor) or orders.device != dev
                or orders.dim() != 2):
            raise ValueError(f"orders_list[{b}]: expected a (T, S) index tensor "
                             "on the matrices' device")
        T, steps = orders.shape
        if steps > 0 and T > 0 and (int(orders.min()) < 0 or int(orders.max()) >= n):
            raise ValueError(f"orders_list[{b}]: indices outside [0, {n})")
        o = orders.to(torch.int32).contiguous()
        w = torch.zeros((T, n), dtype=torch.float32, device=dev)
        inter = torch.zeros((T, n), dtype=torch.float64, device=dev)
        keep.append(o)
        out.append((w, inter))
        lanes += [(I.data_ptr(), n, o.data_ptr() + 4 * t * steps, steps, T,
                   w.data_ptr() + 4 * t * n, inter.data_ptr() + 8 * t * n)
                  for t in range(T)]
    if not lanes:
        return out
    lib, fn = _build.entry("replay", "dipole_replay_batched",
                           [_PTRS, _INTS, _PTRS, _INTS, _INTS, _PTRS, _PTRS, _N_,
                            _P_, _P_, _P_])
    _, scratch = _build.entry("replay", "dipole_replay_scratch", [_N_, _P_, _P_])
    sizes = (ctypes.c_longlong(), ctypes.c_longlong())
    scratch(len(lanes), ctypes.byref(sizes[0]), ctypes.byref(sizes[1]))
    part = torch.empty(sizes[0].value, dtype=torch.float64, device=dev)
    tri = torch.empty(sizes[1].value, dtype=torch.float32, device=dev)
    cols = list(zip(*lanes))
    ptrs = [(ctypes.c_void_p * len(c))(*c) for c in (cols[0], cols[2], cols[5], cols[6])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs[0], _ints(cols[1]), ptrs[1], _ints(cols[3]), _ints(cols[4]),
                 ptrs[2], ptrs[3], len(lanes), part.data_ptr(), tri.data_ptr(), stream)
    _build.check(lib, err, "dipole_replay_batched")
    _count("replay_batched", blocks=len(lanes))
    return out

