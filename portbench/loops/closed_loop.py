"""Closed loop: one caller, calls back to back.

The entry's Program makes its inputs from the seed and warms the cell's
shapes in set-up. The window then calls it, input i for call i, until
`seconds` have passed; the last call ends the window. call_s is the
window's seconds over the calls completed in it. Once the window has
closed and the memory peak is read, the program's state is freed and a
sample of the calls, drawn from the seed, is held to the plain reference.
"""
from __future__ import annotations

import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np


class _Stage:
    """One stage: a host range for the trace around the program's own clock."""

    def __init__(self, label: str, clock):
        import torch

        self._range = torch.profiler.record_function(label)
        self._clock = clock

    def __enter__(self):
        self._range.__enter__()
        self._clock.__enter__()
        return self

    def __exit__(self, *exc):
        self._clock.__exit__(*exc)
        self._range.__exit__(*exc)
        return False


def stage_timer(program_factory):
    """A `timer=` for the program's API: each stage is a record_function
    range (read only by a traced run) around the program's stage clock
    (utils/timing.py, which synchronizes at the stage's end). `stages`
    holds the seconds by label over every call."""
    clock = program_factory()

    def make(label: str = "", count: bool = True):
        return _Stage(label, clock(label, count))

    make.stages = clock.stages
    return make


def sample_indices(seed: int, done: int, count: int) -> list:
    """`count` distinct call indices in [0, done), drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    return sorted(int(i) for i in rng.choice(done, size=min(count, done), replace=False))


def run(ctx) -> SimpleNamespace:
    cell = ctx.cell
    entry = cell.entry()
    prog = entry.Program(cell.config, cell.traffic, ctx.seed, ctx.device)
    setup_s = time.perf_counter() - ctx.t0
    timer = stage_timer(prog.timer_factory())
    before = prog.counters()
    outputs, failed = [], 0
    with ctx.tracer.profiling(), ctx.tracer.window():
        t_start = time.perf_counter()
        while True:
            try:
                outputs.append(prog.call(len(outputs), timer))
            except Exception:  # noqa: BLE001 — a failed call is counted and judged
                traceback.print_exc(file=sys.stderr)
                outputs.append(None)
                failed += 1
            window_s = time.perf_counter() - t_start
            if window_s >= ctx.seconds:
                break
    after = prog.counters()
    memory_peak = prog.memory_peak()
    timeline = ctx.tracer.read()
    calls = len(outputs)
    done = calls - failed
    picks = sample_indices(ctx.seed, calls, int(cell.traffic["check_calls"]))
    inputs = prog.inputs(picks)
    answers = [outputs[i] for i in picks]
    if not done:
        raise RuntimeError("no call completed in the window")
    delta = {k: after[k] - before[k] for k in before}
    work = prog.work(done, delta)
    setup_parts = prog.setup_parts
    prog.close()
    del prog, outputs
    t_check = time.perf_counter()
    numbers = entry.check(cell.config, inputs, answers, ctx.device)
    check_s = time.perf_counter() - t_check
    values = {"setup_s": setup_s, "call_s": window_s / done}
    return SimpleNamespace(
        values=values, numbers=numbers, attempted=calls, failed=failed,
        memory_peak=memory_peak, timeline=timeline, notes=[
            f"closed_loop calls {calls} failed {failed} window_s {window_s!r} "
            f"checked {picks} check_s {check_s!r}",
            f"set-up parts {setup_parts}"],
        readers=SimpleNamespace(root=ctx.root, calls=done, window_s=window_s,
                                stages=dict(timer.stages), timeline=timeline,
                                counters=delta, work=work))
