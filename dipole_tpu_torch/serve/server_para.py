"""Multithreaded TCP orientation server with admission control and
micro-batching — the port of dipole_tpu/serve/server_para.py.

Parity with reference socket_server_para.py: thread-per-connection capped at
max_thread (:200-211), quadratic-memory admission control on sum N^2 <=
30000^2 with poll-sleep queuing (:16-59), colored console + file logging
(:22-34), degenerate-input short-circuit (:70-75), and the five-function
dispatch (:167-186). Concurrent simple_estimate and tree_xie requests are
micro-batched into one greedy launch and one replay launch
(serve/batching.py). The --gpu flag becomes --device: "cuda" (the default),
"cuda:N", an integer N (cuda:N, the JAX device index's twin) or "cpu";
scale-out remains one server process per device.

Spans (utils/timing.py's ring, in this process): each connection is a
request with an id of its own, the `serve.request` span on its handler
thread, and beneath it `serve.read` (the header and the cloud),
`serve.admission` (the quota, its poll included), `serve.estimate` (kNN,
PCA, transform), `serve.queue` (from the micro-batcher's submit until a
leader hands its job to a runner), `transform.inverse` (after the
propagation) and `serve.reply`; one `serve.core` span a batch on its
leader's thread lists the request ids it ran. Warm-up spans carry no request id. Start and
end are `time.time_ns()`: in a torch.profiler Chrome trace a span starts at
ts = (start_ns - baseTimeNanoseconds) / 1000 µs, and its record_function
range is in the trace when the profiler was started with
`_ExperimentalConfig(profile_all_threads=True)` before the handler thread
began. `Server.stop()` logs each serve span's count, p50, p95 and max to
info.log, over the requests still in the ring (the newest 65536 spans).
`tools/span_closure.py` reports how far a request's spans cover it.

    python -m dipole_tpu_torch.serve.server_para --port 12345
    python -m dipole_tpu_torch.serve.server_para --port 12345 --device cpu
"""
from __future__ import annotations

import argparse
import os
import socket
import threading
import time
from pathlib import Path

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.serve import protocol
from dipole_tpu_torch.serve.handlers import dispatch
from dipole_tpu_torch.utils import timing

HOST = "0.0.0.0"
PORT = 12345
MAX_THREAD = 50
MAX_PTS = 30000 * 30000

_COLORS = {"error": "\033[1;31m", "warning": "\033[1;33m", "info": "\033[1;32m"}


def log_msg(msg: str, mode: str = "error", log_dir: str = ".") -> None:
    now = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    color = _COLORS.get(mode, _COLORS["info"])
    print(f"{color}{msg}\033[0m")
    # logging must never take down the server or a warmup (callers pass
    # log_dirs that may not exist yet when not routed through main())
    try:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(log_dir) / f"{mode}.log", "a") as f:
            f.write(f"{now} {msg}\n")
    except OSError:
        pass


def parse_device(value) -> str:
    """--device: "cuda", "cuda:N", "cpu", or an integer N meaning "cuda:N"."""
    text = str(value).strip()
    return f"cuda:{text}" if text.isdigit() else text


class AdmissionControl:
    """Quota on concurrently processed sum-of-N^2 (reference
    socket_server_para.py:37-67). Oversized single jobs are rejected;
    other jobs queue, polling every poll_s seconds."""

    def __init__(self, max_pts: int = MAX_PTS, poll_s: float = 20.0,
                 log_dir: str = "."):
        self.max_pts = max_pts
        self.res_pts = max_pts
        self.poll_s = poll_s
        self.log_dir = log_dir
        self._mtx = threading.Lock()

    def acquire(self, n_points: int) -> None:
        with timing.span("serve.admission"):
            need = n_points * n_points
            if need > self.max_pts:
                msg = (f"job exceeds the quadratic-memory quota: needs {need} "
                       f"pair units, cap is {self.max_pts} — rejected")
                log_msg(msg, mode="error", log_dir=self.log_dir)
                raise ValueError(msg)
            warned = False
            while True:
                with self._mtx:
                    if need <= self.res_pts:
                        self.res_pts -= need
                        return
                if not warned:
                    print(f"quota full ({self.res_pts} of {self.max_pts} pair "
                          f"units free, job needs {need}); queuing")
                    warned = True
                time.sleep(self.poll_s)

    def release(self, n_points: int) -> None:
        with self._mtx:
            self.res_pts += n_points * n_points


class Server:
    def __init__(self, host=HOST, port=PORT, max_thread=MAX_THREAD,
                 admission: AdmissionControl | None = None,
                 log_dir: str = ".", microbatch: bool = True,
                 microbatch_window_s: float = 0.01, device="cuda"):
        self.host = host
        self.port = port
        self.max_thread = max_thread
        self.log_dir = log_dir
        self.device = resolve_device(parse_device(device))
        self.admission = admission or AdmissionControl(log_dir=log_dir)
        self._stop = threading.Event()
        self._since_ns = time.time_ns()
        self.batcher = None
        if microbatch:
            from dipole_tpu_torch.serve.batching import MicroBatcher

            self.batcher = MicroBatcher(window_s=microbatch_window_s)

    def _log(self, msg: str, mode: str = "error") -> None:
        log_msg(msg, mode=mode, log_dir=self.log_dir)

    def handle_client(self, conn: socket.socket, addr) -> None:
        with conn, timing.span("serve.request", request=True):
            print(f"client connected: {addr}")
            acquired = 0
            try:
                with timing.span("serve.read"):
                    req, xyz = protocol.read_request(conn)
                print(req)
                self.admission.acquire(len(xyz))
                acquired = len(xyz)
                result = dispatch(req["function_name"], xyz,
                                  req.get("function_config", {}),
                                  log=self._log, batcher=self.batcher,
                                  device=self.device)
                with timing.span("serve.reply"):
                    protocol.send_result(conn, result)
            except Exception as e:  # noqa: BLE001
                print(f"Error: {e}")
                self._log(f"Error: {e}", mode="error")
                with timing.span("serve.reply"):
                    protocol.send_error(conn)
            finally:
                if acquired:
                    self.admission.release(acquired)

    def serve_forever(self) -> None:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((self.host, self.port))
            s.listen()
            s.settimeout(1.0)
            print(f"Server listening on {self.host}:{self.port}")
            while not self._stop.is_set():
                try:
                    conn, addr = s.accept()
                except socket.timeout:
                    continue
                while threading.active_count() > self.max_thread:
                    time.sleep(1)
                t = threading.Thread(target=self.handle_client, args=(conn, addr),
                                     daemon=True)
                t.start()
                print(f"handler threads alive: {threading.active_count()}")

    def stop(self):
        if self.batcher is not None and self.batcher.jobs_run:
            b = self.batcher
            self._log(
                f"micro-batching: {b.jobs_run} device jobs in "
                f"{b.batches_run} batches "
                f"({b.jobs_run / max(b.batches_run, 1):.2f} jobs/batch)",
                mode="info")
        for line in _span_lines(timing.spans(), self._since_ns):
            self._log(line, mode="info")
        self._stop.set()


SERVE_SPANS = ("serve.request", "serve.read", "serve.admission",
               "serve.estimate", "serve.queue", "serve.core",
               "transform.inverse", "serve.reply")


def _span_lines(spans, since_ns: int) -> list:
    """The spans of the requests whose `serve.request` started at or after
    `since_ns`: a line that says how many requests and since when, then one
    per serve span name with count, p50, p95 and max in ms (`serve.core`
    once a batch). The ring keeps only the newest timing.SPAN_RING spans;
    where it is full, the first line says that older ones may be gone."""
    import numpy as np

    ids = {s.request for s in spans
           if s.name == "serve.request" and s.start_ns >= since_ns}
    ms = {name: [] for name in SERVE_SPANS}
    oldest = None
    for s in spans:
        if s.name in ms and s.request in ids:
            ms[s.name].append((s.end_ns - s.start_ns) * 1e-6)
            oldest = s.start_ns if oldest is None else min(oldest, s.start_ns)
    if not ids:
        return []
    since = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(oldest * 1e-9))
    head = f"spans of {len(ids)} requests, the oldest span counted at {since}"
    if len(spans) >= timing.SPAN_RING:
        head += (f"; the span ring is full ({timing.SPAN_RING} spans), so older "
                 "requests may be gone and these figures cover the newest only")
    return [head] + [
        f"span {name}: {len(v)} p50 {np.percentile(v, 50):.2f} ms "
        f"p95 {np.percentile(v, 95):.2f} ms max {max(v):.2f} ms"
        for name, v in ms.items() if v]


def warmup(sizes, functions=("simple_estimate", "tree_xie_propagation"),
           log_dir: str = ".", microbatch: bool = True, device="cuda"):
    """Warm the server up before it serves: on the card, build the ten
    kernel libraries of csrc/ (nvcc, seconds; an unwarmed server bills the
    first client the build), then run each function once per size and, with
    micro-batching, its batched cores at B = 1, 2, 4 and 8, so that the
    first CUDA work of every path (context, allocator, library loads) is
    done too."""
    import numpy as np

    dev = resolve_device(parse_device(device))
    if dev.type == "cuda":
        from dipole_tpu_torch.ops import _build

        t0 = time.time()
        try:
            for name in _build.build_all():
                _build.library(name)
            log_msg(f"warmup: kernel libraries ready in {time.time() - t0:.1f}s",
                    mode="info", log_dir=log_dir)
        except Exception as e:  # noqa: BLE001 — the first request raises again
            log_msg(f"warmup: kernel build failed: {e}", mode="warning",
                    log_dir=log_dir)
    configs = {
        "simple_estimate": {"diffuse": True},
        "xie_propagation": {"max_nn": 10, "eps": 1e-2, "diffuse": True},
        "tree_xie_propagation": {"max_nn": 10, "eps": 1e-2, "diffuse": True,
                                 "times": 3, "knn_mask": -1, "C": 3},
        "hoppe_estimate": {"k_neighbor": 10, "r": 0.1},
    }
    rng = np.random.default_rng(0)
    for n in sizes:
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        xyz = (v + rng.normal(scale=0.01, size=v.shape)) * 0.05
        for fn in functions:
            t0 = time.time()
            try:
                dispatch(fn, xyz, configs[fn], device=dev)
                log_msg(f"warmup {fn} n={n}: {time.time() - t0:.1f}s",
                        mode="info", log_dir=log_dir)
            except Exception as e:  # noqa: BLE001
                log_msg(f"warmup {fn} n={n} failed: {e}", mode="warning",
                        log_dir=log_dir)
        if microbatch:
            _warmup_batched(xyz, functions, n, log_dir, dev)


def _warmup_batched(xyz, functions, n, log_dir, dev):
    """Run the micro-batched cores once at batch sizes 1, 2, 4 and 8 (the
    MicroBatcher caps batches at 8), so that an uncontended B = 1 request,
    which still routes through the batched cores, and the first waves find
    every batched path warm."""
    from dipole_tpu_torch.ops import propagate
    from dipole_tpu_torch.serve import batching
    from dipole_tpu_torch.serve.handlers import _prep

    pc, _ = _prep(xyz, 30, dev)
    orders = None
    if "tree_xie_propagation" in functions:
        try:
            orders, _ = propagate.bfs_orders(pc, 0, times=3)
        except Exception as e:  # noqa: BLE001 — warmup must not kill startup
            log_msg(f"warmup tree_xie batch orders failed: {e}",
                    mode="warning", log_dir=log_dir)
    for B in (1, 2, 4, 8):
        if "simple_estimate" in functions:
            t0 = time.time()
            try:
                batching._simple_core_batch([(pc, True, dev)] * B)
                log_msg(f"warmup simple_estimate batch B={B} n={n}: "
                        f"{time.time() - t0:.1f}s", mode="info",
                        log_dir=log_dir)
            except Exception as e:  # noqa: BLE001
                log_msg(f"warmup simple_estimate batch B={B} failed: {e}",
                        mode="warning", log_dir=log_dir)
        if "tree_xie_propagation" in functions and orders is not None:
            t0 = time.time()
            try:
                batching._tree_xie_core_batch([(pc, orders, True, 3.0, dev)] * B)
                batching._mean_potential_batch([(pc, dev)] * B)
                log_msg(f"warmup tree_xie batch B={B} n={n}: "
                        f"{time.time() - t0:.1f}s", mode="info",
                        log_dir=log_dir)
            except Exception as e:  # noqa: BLE001
                log_msg(f"warmup tree_xie batch B={B} failed: {e}",
                        mode="warning", log_dir=log_dir)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=PORT)
    parser.add_argument("--host", type=str, default=HOST)
    parser.add_argument("--max_thread", type=int, default=MAX_THREAD)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, cuda:N, an integer N (cuda:N; the "
                             "reference's --gpu) or cpu")
    parser.add_argument("--log_dir", type=str, default=".",
                        help="directory for error/warning/info .log files")
    parser.add_argument("--warmup", type=str, default="",
                        help="comma-separated point counts to warm up for, "
                             "e.g. 2000,10000")
    parser.add_argument("--mesh", type=str,
                        default=os.environ.get("DIPOLE_TPU_MESH"),
                        help="multi-device: device count or 'auto' "
                             "(default: DIPOLE_TPU_MESH env; unset = 1 device; "
                             "with --device cpu, N CPU shards)")
    parser.add_argument("--no_microbatch", action="store_true",
                        help="disable fusing concurrent requests into one "
                             "batched device call")
    parser.add_argument("--microbatch_window_ms", type=float, default=10.0,
                        help="how long a batch leader waits for followers")
    args = parser.parse_args(argv)
    device = parse_device(args.device)
    resolve_device(device)
    if args.mesh:
        from dipole_tpu_torch.serve import handlers

        handlers.set_mesh(args.mesh, device=device)
    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    if args.warmup:
        warmup([int(x) for x in args.warmup.split(",") if x],
               log_dir=args.log_dir, microbatch=not args.no_microbatch,
               device=device)
    server = Server(args.host, args.port, args.max_thread,
                    log_dir=args.log_dir, microbatch=not args.no_microbatch,
                    microbatch_window_s=args.microbatch_window_ms / 1000.0,
                    device=device)
    server.serve_forever()


if __name__ == "__main__":
    main()
