"""Find the highest offered rate an open-loop cell sustains, once, by a sweep.

    python3 portbench/sweep.py --workload simple10k.serve --seed 7
        --seconds 20 --rates 10,20,30,40 [--limit-ms 500]

Starts the cell's server once (the entry's Program, warmed as in a run),
then for each rate runs the cell's open-loop client for `seconds` and prints
one JSON line: p50 and p95 latency (ms, from when each request was due),
failures, jobs per batch, and whether the backlog grew (the median latency
of the window's last quarter over its first quarter's, and the last
quarter's above the limit). A rate is sustained when p95 is at or under the
limit, nothing failed and the backlog did not grow. The cell's traffic file
then fixes its rate below the highest sustained one; run.py never searches.
"""
import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench.loops.open_loop import Client, summary  # noqa: E402

GROWTH = 2.0   # last quarter's median latency over the first's that counts as a growing backlog


def backlog(data: dict, limit_ms: float) -> dict:
    import numpy as np

    lat = np.asarray(data["latency"]) * 1e3
    q = max(1, len(lat) // 4)
    first, last = float(np.median(lat[:q])), float(np.median(lat[-q:]))
    return {"first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
            "growing": bool(last > GROWTH * first and last > limit_ms)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--limit-ms", type=float, default=500.0)
    args = p.parse_args(argv)
    import torch

    cell = core.Cell(args.workload)
    device = torch.device("cuda:0")
    section = cell.config[cell.config["entries"]["open_loop"]]
    entry = cell.entry()
    scratch = tempfile.mkdtemp(prefix="portbench-sweep-")
    log = open(os.path.join(scratch, "program.log"), "w")
    stack = contextlib.ExitStack()
    stack.enter_context(log)
    stack.enter_context(contextlib.redirect_stdout(log))
    prog = entry.Program(cell.config, cell.traffic, args.seed, device, scratch)
    try:
        prog.warm()
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            client = Client(prog.port, args.seed + k, args.seconds, cell.traffic,
                            section["function_name"], section["function_config"],
                            scratch, rate=rate)
            try:
                client.expect("READY")
                before = prog.counters()
                t = time.perf_counter()
                client.go()
                client.expect("CLOSED")
                data = client.result()
            finally:
                client.stop()
            after = prog.counters()
            stats = summary(data)
            grow = backlog(data, args.limit_ms)
            jobs = after["jobs_run"] - before["jobs_run"]
            batches = after["batches_run"] - before["batches_run"]
            line = dict(rate_per_s=rate, **stats, **grow,
                        jobs_per_batch=jobs / batches if batches else None,
                        seconds=time.perf_counter() - t,
                        sustained=bool(stats["latency_p95_ms"] <= args.limit_ms
                                       and stats["failed"] == 0 and not grow["growing"]))
            print(json.dumps(line), file=sys.__stdout__, flush=True)
    finally:
        prog.close()
        stack.close()
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
