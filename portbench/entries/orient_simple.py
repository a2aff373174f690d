"""The program's `api.orient_simple` on ellipsoids, positions only.

Set-up builds the kernels (a cached build in the checkout after a cell's
first run), makes `samples` + 1 clouds from the seed in one call on the
device, and warms the cell's one shape with the extra cloud. Call i orients
cloud i mod `samples` with the configuration's keywords.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import samplers
from portbench.counts import ops
from portbench.reference import simple as reference


def program_counters() -> dict:
    """The port's launch counters, flat ("launch.<kernel>")."""
    from dipole_tpu_torch.ops import fields_cuda, neighbors_cuda, propagate_cuda

    out = {}
    for table in (propagate_cuda.LAUNCHES, fields_cuda.LAUNCHES, neighbors_cuda.LAUNCHES):
        for name, count in table.items():
            out[f"launch.{name}"] = int(count)
    return out


def build(device) -> None:
    """Build (or find built) and load every kernel library of the port."""
    if device.type != "cuda":
        return
    from dipole_tpu_torch.ops import _build

    for name in _build.build_all():
        _build.library(name)


class Program:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        t = time.perf_counter()
        from dipole_tpu_torch import api
        from dipole_tpu_torch.utils import timing

        self.api, self.timing, self.device = api, timing, device
        self.kw = dict(config["orient_simple"])
        self.setup_parts = {"import_s": time.perf_counter() - t}
        t = time.perf_counter()
        build(device)
        self.setup_parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.n = int(traffic["points"])
        self.samples = int(traffic["samples"])
        self.clouds = samplers.ellipsoid_batch(self.samples + 1, self.n, seed,
                                               tuple(traffic["axes"]), device=device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.setup_parts["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._orient(self.clouds[self.samples], None)
        self.setup_parts["warm_s"] = time.perf_counter() - t

    def _orient(self, cloud, timer):
        return self.api.orient_simple(cloud[:, :3], timer=timer, device=self.device,
                                      **self.kw)

    def timer_factory(self):
        return self.timing.timer_factory

    def call(self, i: int, timer):
        return self._orient(self.clouds[i % self.samples], timer)

    def counters(self) -> dict:
        return program_counters() if self.device.type == "cuda" else {}

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def inputs(self, picks):
        return np.stack([self.clouds[i % self.samples] for i in picks])

    def work(self, calls: int, counters: dict) -> dict:
        """Operations and bytes of the window's calls, from the shapes."""
        col_ops, col_bytes = ops.greedy_columns(self.n)
        cols = counters.get("launch.greedy_columns", 0)
        return {"call_ops": calls * ops.orient_simple_call(self.n),
                "greedy_columns": (cols * col_ops, cols * col_bytes)}

    def close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def reference_answers(config: dict, inputs, device, dtype=torch.float64):
    """(answers, undecided) of the plain reference (reference/simple.py) on
    the inputs the program got, computed in `dtype`."""
    ref = config["reference"]
    return reference.orient(np.asarray(inputs)[..., :3], ref["max_nn"], ref["radius"],
                            config["orient_simple"]["diffuse"], ref["eps"],
                            dtype=dtype, device=device)


def check(config: dict, inputs, answers, device) -> dict:
    """The compared numbers of the sampled answers (None: never came)."""
    want, loose = reference_answers(config, inputs, device)
    return reference.judge(inputs, answers, want, loose)
