"""Stage timers and the span recorder — the stage timers port
dipole_tpu/utils/timing.py:19-70.

Named stages print on entry and exit and accumulate into a run total. A
stage ends with torch.cuda.synchronize() when CUDA is in use, so its host
clock covers the device work queued inside it. Each stage's seconds are also
kept by label (`make.stages`), so a caller can report the breakdown.

Spans. `span(name, **tags)` records where the program's time goes, on the
host: every stage is one, and the API and the server open their own (see
PERF.md's list of layers). A span holds its name, its start and end in
`time.time_ns()`, the native id of its thread, the id of the span open
around it on that thread (`parent`), the request current on the thread
(`request`) and its tags. A span opened with `request=True` where no request
is current makes its own id the thread's request until it closes: the API's
`api.orient_simple` root, the server's `serve.request`. Closed spans go into
one ring per process, the newest SPAN_RING of them (`spans()` returns a
snapshot, `clear_spans()` empties it). Spans never synchronize or copy
between host and device: a span around queued device work closes when the
host is done with it, unless a stage clock inside waited.

The clock is the one torch.profiler's Chrome trace counts from: an event's
`ts` is microseconds since `baseTimeNanoseconds` (the trace's header), so a
span starts at `ts` = (start_ns - baseTimeNanoseconds) / 1000 there. While a
profiler records anywhere in the process, a span is also a
`torch.profiler.record_function(name)` range, inside its start and end. A
profiler records the ranges of the thread that started it, and of threads
started after it when it was given
`experimental_config=_ExperimentalConfig(profile_all_threads=True)`. The
range is left out otherwise: it costs more than the rest of a span.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

__all__ = ["span", "spans", "clear_spans", "current_request",
           "timer_factory", "SPAN_RING"]

SPAN_RING = 65536

_RING: collections.deque = collections.deque(maxlen=SPAN_RING)
_RING_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current_request():
    """The id of the request current on this thread, or None."""
    return getattr(_LOCAL, "request", None)


class _Span:
    """One span; a context manager (see the module docstring). Inside it,
    `end_ns` may be set to a stamp already taken: the span then ends there
    instead of when it closes (a wait that ended on another thread's clock)."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent",
                 "request", "tags", "_opens", "_range")

    def __init__(self, name: str, request: bool = False, **tags):
        self.id = next(_IDS)
        self.name = name
        self.tags = tags
        self._opens = request
        self.start_ns = self.end_ns = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        stack = _stack()
        self.thread = threading.get_native_id()
        self.parent = stack[-1].id if stack else None
        if self._opens and current_request() is None:
            _LOCAL.request = self.id
        else:
            self._opens = False
        self.request = current_request()
        stack.append(self)
        self._range = None
        # torch's process-wide flag that a profile records; the per-thread
        # torch.autograd._profiler_enabled() is false in a handler thread
        # under an all-threads profile
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.end_ns is None:
            self.end_ns = time.time_ns()
        _stack().pop()
        if self._opens:
            _LOCAL.request = None
        with _RING_LOCK:
            _RING.append(self)
        return False


span = _Span


def spans() -> list:
    """A snapshot of the ring, oldest closed span first."""
    with _RING_LOCK:
        return list(_RING)


def clear_spans() -> None:
    with _RING_LOCK:
        _RING.clear()


def _humanize(seconds: float) -> str:
    if seconds < 60.0:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60.0)
    return f"{int(m)}m {s:04.1f}s"


class _StageClock:
    """Context manager for one named stage, recorded as a span under its
    label; created through a factory so every pipeline run gets a private
    accumulated total."""

    def __init__(self, ledger: dict, label: str = "", count: bool = True):
        self._ledger = ledger
        self.label = label
        self._accumulate = count
        self.duration = 0.0
        self._span = None

    def __enter__(self):
        if self.label:
            print(f"started: {self.label}")
        self._span = _Span(self.label).__enter__()
        # the stage's seconds stay on perf_counter, the clock `make.stages`
        # and the CLIs' printout have always read; the span's time_ns stamps
        # place the stage on the profiler trace's clock
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            self.duration = time.perf_counter() - self._t0
            self._span.__exit__(*exc)
        if self._accumulate:
            self._ledger["total"] += self.duration
        stages = self._ledger["stages"]
        stages[self.label] = stages.get(self.label, 0.0) + self.duration
        if self.label:
            print(f"finished: {self.label} [{_humanize(self.duration)}]")
        return False


def timer_factory():
    """Returns a stage-clock constructor with a fresh accumulator.

    Usage mirrors the pipelines: ``T = timer_factory(); with T("stage"): ...;
    T.print_total_time()``. Stages created with ``count=False`` print but do
    not add to the total.
    """
    ledger = {"total": 0.0, "stages": {}}

    def make(label: str = "", count: bool = True) -> _StageClock:
        return _StageClock(ledger, label, count)

    def print_total_time() -> None:
        print(f"\ntotal time: {_humanize(ledger['total'])}")

    make.print_total_time = print_total_time
    make.total = lambda: ledger["total"]
    make.stages = ledger["stages"]
    return make
