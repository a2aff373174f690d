"""The traced run's device timeline: torch.profiler over the window, read
back from its Chrome trace.

Device operations are the trace's kernels, copies and sets. The window is
the benchmark's own `portbench.window` range. Busy time is the union of
device operations inside it; an idle gap is a stretch of it with none,
named by the innermost host range (record_function) open at its middle
(the profiler's own step ranges left out).
"""
from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Timeline:
    """Device operations and host ranges of one traced window."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no portbench.window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ops = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.t1)
                if b > a:
                    self.ops.append((a, b, e.get("name", "?")))
        self.ops.sort()
        self.ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                        e.get("name", "?")) for e in events
                       if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                       and e.get("name") != WINDOW
                       and not e.get("name", "").startswith("ProfilerStep")]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for a, b, _ in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, part: str):
        """(seconds, launches) of the device operations whose name holds
        `part`, inside the window."""
        hits = [(a, b) for a, b, n in self.ops if part in n]
        return sum(b - a for a, b in hits) * 1e-6, len(hits)

    def gaps(self) -> list:
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_range_at(self, t: float) -> str:
        best = None
        for a, b, name in self.ranges:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "outside the benchmark's ranges"

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for a, b, n in self.ops:
            by_op[n[:200]] += (b - a) * 1e-6
        by_host = defaultdict(float)
        for a, b in self.gaps():
            by_host[self.host_range_at(0.5 * (a + b))] += (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


class Tracer:
    """Profiles the window when on, and does nothing else when off (the
    untraced run pays for no profiler). `profiling()` starts the profiler
    in its warm-up state (CUPTI's start-up stall falls before the window)
    and ends it, reading nothing, once the caller has no more work running
    (for a server: after the drain); `window()` records inside it."""

    def __init__(self, on: bool, scratch: str):
        self.on = on
        self.path = os.path.join(scratch, "trace.json")
        self.timeline = None
        self._prof = None

    @contextlib.contextmanager
    def profiling(self):
        import torch

        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        plan = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=plan,
                                    on_trace_ready=lambda p: p.export_chrome_trace(self.path)) as prof:
            self._prof = prof
            yield
            prof.step()
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        import torch

        if self._prof is not None:
            self._prof.step()
        with torch.profiler.record_function(WINDOW):
            yield

    def read(self) -> Timeline | None:
        """The window's timeline (None when untraced), from the trace written
        to the scratch directory, deleted once read."""
        if not self.on or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            data = json.load(f)
        os.remove(self.path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.timeline = Timeline(events)
        return self.timeline
