"""The program's threaded TCP server (`serve.server_para.Server`) on
loopback, at the configuration's batch window, thread cap and admission
quota, serving one function.

Set-up builds the kernels and starts the server; `warm()` runs the server's
own warm-up at the traffic's cloud size (each path once, the batched cores
at B = 1, 2, 4 and 8). Its logs go to the run's scratch directory.
"""
from __future__ import annotations

import os
import socket
import threading
import time

import torch

from portbench.counts import ops
from portbench.entries.orient_simple import build, program_counters
from portbench.reference import simple as reference


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Program:
    def __init__(self, config: dict, traffic: dict, seed: int, device, scratch: str):
        t = time.perf_counter()
        from dipole_tpu_torch.serve import server_para

        self.setup_parts = {"import_s": time.perf_counter() - t}
        section = config["server_para"]
        self.server_para, self.device, self.traffic = server_para, device, traffic
        self.function = section["function_name"]
        self.log_dir = os.path.join(scratch, "server")
        t = time.perf_counter()
        build(device)
        self.setup_parts["build_s"] = time.perf_counter() - t
        self.port = free_port()
        admission = server_para.AdmissionControl(
            max_pts=int(section["admission_pair_units"]), log_dir=self.log_dir)
        self.server = server_para.Server(
            host="127.0.0.1", port=self.port, max_thread=int(section["max_thread"]),
            admission=admission, log_dir=self.log_dir,
            microbatch_window_s=float(section["microbatch_window_s"]), device=device)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def warm(self) -> None:
        t = time.perf_counter()
        self.server_para.warmup([int(self.traffic["points"])], functions=(self.function,),
                                log_dir=self.log_dir, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_parts["warm_s"] = time.perf_counter() - t

    def counters(self) -> dict:
        out = program_counters() if self.device.type == "cuda" else {}
        out["jobs_run"] = self.server.batcher.jobs_run
        out["batches_run"] = self.server.batcher.batches_run
        return out

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        self.server.stop()
        self.thread.join(timeout=30)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def work(traffic: dict, counters: dict) -> dict:
    """Operations and bytes of the window's batched greedies: the jobs run in
    batches of two or more (a lone request takes the row greedy, one
    greedy_rows launch), each a column greedy over its cloud."""
    lone = counters.get("launch.greedy_rows", 0)
    batched = max(counters.get("jobs_run", 0) - lone, 0)
    n_ops, n_bytes = ops.greedy_columns(int(traffic["points"]))
    return {"greedy_batched": (batched * n_ops, batched * n_bytes)}


def reference_answers(config: dict, inputs, device, dtype=torch.float64):
    """(answers, undecided) of the plain reference on the clouds sent
    (float64; the program casts them to float32, and so does the reference)."""
    ref = config["reference"]
    diffuse = bool(config["server_para"]["function_config"].get("diffuse", True))
    return reference.orient(inputs, ref["max_nn"], ref["radius"], diffuse, ref["eps"],
                            dtype=dtype, device=device)


def check(config: dict, inputs, answers, device) -> dict:
    """The compared numbers of the sampled replies (None: never came)."""
    want, loose = reference_answers(config, inputs, device)
    return reference.judge(inputs, answers, want, loose)
