"""Server micro-batching: coalesce concurrent requests of one function and
config into one batched device call — the port of
dipole_tpu/serve/batching.py.

The reference's parallel server (socket_server_para.py:200-211) overlaps
requests with threads but runs every request's GPU work on its own. Here
concurrent requests to the same function with equal config on the same
device are fused: the first thread in becomes the batch leader, waits a few
milliseconds for followers, then runs ONE batched greedy launch for the
whole batch (ops/propagate.greedy_sign_sequence_batched, csrc/greedy.cu's
batched entry) or ONE batched replay (ops/propagate.xie_in_order_batched,
csrc/replay.cu's), and the sign fixes together
(ops/fields.measure_mean_potential_batched). The greedy's time is the
latency of its dependent steps, so B requests side by side cost about one
request's time instead of B.

Per-request results are independent of batch composition: each lane reads
only its own cloud, and is bit-equal to the launch over its cloud alone.
The JAX package's padding bucket is not part of the signature: the port
pads nothing, so clouds of any sizes share a batch.
"""
from __future__ import annotations

import itertools
import threading
import time

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.utils import timing

__all__ = ["MicroBatcher", "batched_simple_estimate", "batched_tree_xie",
           "MAX_REPLAY_ENTRIES"]

# Budget of one micro-batched replay: the float32 entries of the B exact
# N_b x N_b matrices it holds at once, sum N_b^2 (no power-of-two lanes, no
# bucket padding). 5e9 entries are 20 GB, a quarter of the 80 GB card: the
# rest stays for the requests that run beside a replay (each server request
# may hold a 30000^2 xie matrix, 3.6 GB) and for the caching allocator. The
# server's admission quota (sum N^2 <= 30000^2 in flight,
# server_para.MAX_PTS) binds first, so the budget binds direct callers
# only: they are chunked, not refused. The budget is checked before any
# matrix of a chunk is built.
MAX_REPLAY_ENTRIES = 5 * 10**9

# One replay batch at a time: each batch is budgeted alone, but leaders for
# DIFFERENT signatures (e.g. two C values) would otherwise build full-budget
# matrix sets concurrently. Greedy and mean-potential batches hold O(sum N)
# and need no such guard.
_REPLAY_HBM_LOCK = threading.Lock()


class _Job:
    __slots__ = ("payload", "result", "error", "event", "request", "started_ns")

    def __init__(self, payload, request=None):
        self.payload = payload
        self.result = None
        self.error = None
        self.event = threading.Event()
        self.request = request          # the submitting thread's request id
        self.started_ns = None          # when its batch's runner was handed it


class MicroBatcher:
    """Coalesces submissions with equal signature into one runner call.

    submit(sig, payload, runner) blocks until the result for `payload` is
    ready. The first thread per signature becomes the leader: it sleeps
    `window_s` to let followers join, then pops up to `max_batch` jobs and
    calls runner([payloads]) -> [results]. Followers just wait. A runner
    exception is re-raised in every waiting thread.

    Spans (utils/timing.py): each submission's wait is a `serve.queue` span,
    from the submit to the moment a leader pops its job for a runner (the
    leader's window, a follower's wait, or the wait behind an earlier
    chunk); each runner call is a `serve.core` span on the leader's thread,
    tagged `batch` (this batcher's count) and `requests` (the submitters'
    request ids). The batched handlers below end, as the others, in the
    request's `transform.inverse` span (handlers._unprep)."""

    def __init__(self, window_s: float = 0.01, max_batch: int = 8):
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._queues: dict = {}
        self.batches_run = 0
        self.jobs_run = 0
        self._batch_ids = itertools.count()

    def submit(self, sig, payload, runner):
        job = _Job(payload, timing.current_request())
        with timing.span("serve.queue") as queued:
            with self._lock:
                queue = self._queues.setdefault(sig, [])
                queue.append(job)
                leader = len(queue) == 1
            if not leader:
                job.event.wait()
            elif self.window_s > 0:
                time.sleep(self.window_s)
            # a leader's job is normally popped by its own first chunk, just
            # after this span; another leader may have popped it already
            queued.end_ns = job.started_ns
        if not leader:
            if job.error is not None:
                raise job.error
            return job.result
        # The leader drains the WHOLE queue in max_batch chunks: followers
        # beyond the first chunk (and any that join while a chunk runs) have
        # no leader of their own and would otherwise wait forever. The
        # signature entry is removed exactly when its queue empties, so a
        # post-drain submit becomes a fresh leader.
        while True:
            with self._lock:
                queue = self._queues.get(sig, [])
                jobs = queue[: self.max_batch]
                del queue[: self.max_batch]
                if not queue:
                    self._queues.pop(sig, None)
                if jobs:
                    batch = next(self._batch_ids)
                    started = time.time_ns()
                    for j in jobs:
                        j.started_ns = started
            if not jobs:
                break
            try:
                with timing.span("serve.core", batch=batch,
                                 requests=[j.request for j in jobs]):
                    results = runner([j.payload for j in jobs])
                if len(results) != len(jobs):
                    raise RuntimeError(
                        f"batch runner returned {len(results)} results for "
                        f"{len(jobs)} jobs")
                for j, r in zip(jobs, results):
                    j.result = r
            except Exception as e:  # noqa: BLE001 — must release every waiter
                for j in jobs:
                    j.error = e
            finally:
                for j in jobs:
                    j.event.set()
            with self._lock:
                self.batches_run += 1
                self.jobs_run += len(jobs)
        # The leader's own job is normally in its first chunk, but a PREVIOUS
        # batch's leader may still be draining this sig and can pop it first
        # (this thread then sees an empty queue and exits the loop while the
        # other leader's runner is mid-flight). The event, not loop exit, is
        # the completion signal.
        job.event.wait()
        if job.error is not None:
            raise job.error
        return job.result


def _simple_core_batch(payloads):
    """Batched device core of simple_estimate: payloads are (pc, diffuse,
    device) with pc already normal-estimated and normalized; returns
    oriented pcs (still normalized — the caller inverts its own transform).
    diffuse and device are constant within a batch (part of the
    signature)."""
    from dipole_tpu_torch.ops import propagate

    return propagate.orient_clouds_batched([p for p, _, _ in payloads],
                                           diffuse=payloads[0][1],
                                           device=payloads[0][2])


def _tree_xie_core_batch(payloads):
    """Batched device core of tree_xie_propagation: payloads are (pc,
    orders, diffuse, C, device); one batched replay runs a chunk of clouds
    at once, chunks cut so that their matrices, sum N_b^2 entries, stay
    inside MAX_REPLAY_ENTRIES (a cloud above it runs alone). Alignment and
    vote stay per request. Returns (N_b, T) flip masks."""
    from dipole_tpu_torch.ops import propagate

    out = [None] * len(payloads)
    i = 0
    while i < len(payloads):
        j, entries = i, 0
        while j < len(payloads):
            e = len(payloads[j][0]) ** 2
            if j > i and entries + e > MAX_REPLAY_ENTRIES:
                break
            entries += e
            j += 1
        chunk = payloads[i:j]
        with _REPLAY_HBM_LOCK:
            flips = propagate.xie_in_order_batched(
                [p[0] for p in chunk], [p[1] for p in chunk],
                diffuse=chunk[0][2], C=chunk[0][3], device=chunk[0][4])
        for k, f in enumerate(flips):
            out[i + k] = f.T                              # (N, T)
        i = j
    return out


def _mean_potential_batch(payloads):
    """payloads (pc, device): the mean lattice potential of each pc."""
    from dipole_tpu_torch.ops import fields

    return list(fields.measure_mean_potential_batched(
        [p for p, _ in payloads], device=payloads[0][1]))


def batched_tree_xie(batcher: MicroBatcher, xyz_data, config, device="cuda"):
    """tree_xie_propagation with the replays micro-batched. Host stages
    (normal estimation, transform, EMST + BFS orders, alignment + vote) stay
    in the calling thread; the sign fixes are batched too."""
    from dipole_tpu_torch.ops import propagate
    from dipole_tpu_torch.serve.handlers import _prep, _unprep

    dev = resolve_device(device)
    times = int(config["times"])
    if times <= 0 or times % 2 != 1:
        raise ValueError("times must be a positive odd number")
    pc, transform = _prep(xyz_data, config["max_nn"], dev)
    diffuse = bool(config["diffuse"])
    C = float(config.get("C", 3))
    orders, _ = propagate.bfs_orders(pc, 0, times=times)
    sig = ("tree_xie", times, diffuse, C, str(dev))
    flips = batcher.submit(sig, (pc, orders, diffuse, C, dev),
                           _tree_xie_core_batch)
    pc, _ = propagate.align_and_vote(pc, flips)
    mean = batcher.submit(("meanpot", str(dev)), (pc, dev), _mean_potential_batch)
    if mean < 0:
        pc[:, 3:6] *= -1
    return _unprep(pc, transform)


def batched_simple_estimate(batcher: MicroBatcher, xyz_data, config,
                            device="cuda"):
    """simple_estimate with the device stages micro-batched. Host stages
    (normal estimation, transform) stay in the calling thread so they still
    overlap across requests."""
    from dipole_tpu_torch.serve.handlers import _prep, _unprep

    dev = resolve_device(device)
    pc, transform = _prep(xyz_data, 30, dev)
    diffuse = bool(config.get("diffuse", True))
    sig = ("simple_estimate", diffuse, str(dev))
    oriented = batcher.submit(sig, (pc, diffuse, dev), _simple_core_batch)
    return _unprep(oriented, transform)
