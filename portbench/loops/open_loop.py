"""Open loop: independent clients at a fixed offered rate.

The entry's Program starts the system under test (a server on loopback) and
warms it in set-up; the client process (open_loop_client.py) makes its
requests from the seed meanwhile. The window opens when the client is told
GO and closes at `seconds`; every request due in it counts, timed from when
it was due, and the run waits up to `drain_s` past the close for the last
replies. A sample of the replies, drawn from the seed, is then held to the
plain reference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

CLIENT = Path(__file__).resolve().parent / "open_loop_client.py"


class Client:
    """The client process for one window, from its READY to its DONE."""

    def __init__(self, port: int, seed: int, seconds: float, traffic: dict,
                 function: str, config: dict, scratch: str, rate=None):
        self.out = os.path.join(scratch, f"client-{seed}-{time.monotonic_ns()}.npz")
        rate = float(traffic["rate_per_s"] if rate is None else rate)
        cmd = [sys.executable, str(CLIENT), "--port", str(port), "--seed", str(seed),
               "--rate", repr(rate), "--seconds", repr(float(seconds)),
               "--points", str(int(traffic["points"])),
               "--check", str(int(traffic["check_requests"])),
               "--drain", repr(float(traffic["drain_s"])),
               "--function", function, "--config", json.dumps(config),
               "--axes", ",".join(str(a) for a in traffic["axes"]), "--out", self.out]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, bufsize=1)

    def expect(self, word: str) -> None:
        line = self.proc.stdout.readline().strip()
        if line != word:
            self.stop()
            raise RuntimeError(f"open-loop client said {line!r}, not {word}")

    def go(self) -> None:
        self.proc.stdin.write("GO\n")
        self.proc.stdin.flush()

    def result(self) -> dict:
        self.expect("DONE")
        self.proc.wait(timeout=60)
        with np.load(self.out) as f:
            data = {k: f[k] for k in f.files}
        os.remove(self.out)
        return data

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def summary(data: dict) -> dict:
    """Latency percentiles (ms, over every request due in the window; a
    failed one counts as taking until the client gave up), the rate served
    (the answers that came between GO and the window's close, over the
    window's seconds), the slowest request and how late the client sent."""
    lat = np.asarray(data["latency"], np.float64) * 1e3
    ok = np.asarray(data["ok"], bool)
    seconds = float(data["seconds"])
    done = np.asarray(data["done"], np.float64)
    served = int((ok & (np.nan_to_num(done, nan=np.inf) <= seconds)).sum())
    slowest = int(np.argmax(lat))
    late = np.asarray(data["lateness"], np.float64) * 1e3
    late = late[np.isfinite(late)]
    return {"served_per_s": served / seconds,
            "latency_max_ms": float(lat[slowest]),
            "slowest_due_s": float(done[slowest] - lat[slowest] * 1e-3)
            if ok[slowest] else None,
            "latest_reply_s": float(np.nanmax(done)) if ok.any() else None,
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "attempted": int(len(lat)), "failed": int((~ok).sum()),
            "late_p50_ms": float(np.percentile(late, 50)) if late.size else None,
            "late_max_ms": float(late.max()) if late.size else None}


def run(ctx) -> SimpleNamespace:
    cell = ctx.cell
    entry = cell.entry()
    section = cell.config[cell.config["entries"]["open_loop"]]
    prog = entry.Program(cell.config, cell.traffic, ctx.seed, ctx.device, ctx.scratch)
    client = None
    try:
        client = Client(prog.port, ctx.seed, ctx.seconds, cell.traffic,
                        section["function_name"], section["function_config"],
                        ctx.scratch)
        prog.warm()
        client.expect("READY")
        setup_s = time.perf_counter() - ctx.t0
        with ctx.tracer.profiling():
            before = prog.counters()
            with ctx.tracer.window():
                t_start = time.perf_counter()
                client.go()
                client.expect("CLOSED")
                window_s = time.perf_counter() - t_start
            after = prog.counters()
            data = client.result()
    finally:
        if client is not None:
            client.stop()
        memory_peak = prog.memory_peak()
        prog.close()
    timeline = ctx.tracer.read()
    stats = summary(data)
    delta = {k: after[k] - before[k] for k in before}
    work = entry.work(cell.traffic, delta)
    setup_parts = prog.setup_parts
    del prog
    t_check = time.perf_counter()
    answers = [r if have else None for r, have in zip(data["replies"], data["have"])]
    numbers = entry.check(cell.config, data["sent_xyz"], answers, ctx.device)
    check_s = time.perf_counter() - t_check
    values = dict(stats, setup_s=setup_s)
    notes = [f"open_loop requests {stats['attempted']} failed {stats['failed']} "
             f"served {stats['served_per_s']!r} /s slowest {stats['latency_max_ms']!r} ms "
             f"due at {stats['slowest_due_s']!r} s latest reply {stats['latest_reply_s']!r} s "
             f"p50 {stats['latency_p50_ms']!r} ms p95 {stats['latency_p95_ms']!r} ms "
             f"window_s {window_s!r} client late p50 {stats['late_p50_ms']!r} ms "
             f"max {stats['late_max_ms']!r} ms checked {data['picks'].tolist()} "
             f"check_s {check_s!r}", f"set-up parts {setup_parts}"]
    return SimpleNamespace(
        values=values, numbers=numbers, attempted=stats["attempted"],
        failed=stats["failed"], memory_peak=memory_peak, timeline=timeline,
        notes=notes,
        readers=SimpleNamespace(root=ctx.root, calls=stats["attempted"],
                                window_s=window_s, stages={}, timeline=timeline,
                                counters=delta, work=work,
                                latency_p50_ms=stats["latency_p50_ms"]))
