"""Shared helpers of portbench's CPU tests: shrink a cell's traffic in a
copied checkout and run it on the CPU through run.execute."""
import json
import time

SMALL = {
    "closed.ellipsoid180k": {"points": 5000, "samples": 2, "check_calls": 1},
    "open.ellipsoid10k": {"points": 5000, "rate_per_s": 4.0, "check_requests": 2,
                          "drain_s": 30},
}


def shrink(root, traffic: str, **extra) -> None:
    path = root / "portbench" / "traffic" / f"{traffic}.json"
    t = json.loads(path.read_text())
    t.update(SMALL[traffic], **extra)
    path.write_text(json.dumps(t))


def run_cpu(root, workload: str, seed: int = 4294967311, seconds: float = 1.5,
            trace: int = 0):
    """(result dict, stderr lines) of one CPU run of the cell in `root`."""
    from portbench import run

    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    line, lines = run.execute(args, device="cpu", root=root, t0=time.perf_counter())
    return json.loads(line), lines
