"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Set-up
(import, kernel libraries, inputs from the seed, warm-up of the cell's
shapes) is timed from the start of this file; then the cell's traffic runs
for `--seconds`, untraced (`--trace 0`: the end-to-end metrics) or under
torch.profiler (`--trace 1`: the per-layer metrics, the device's busy time
and a breakdown). The answers are then held to the plain reference; the
numbers compared and their limits are the last lines on standard error and
the last key of the result. The program's own prints and logs go to a
scratch directory under TMPDIR, removed at the end.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


class NoCard(RuntimeError):
    pass


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cuda_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch sees "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda:0")


def execute(args, device=None, root: Path = ROOT, t0: float = T0):
    """Run the cell; returns (result line, stderr lines). `device` None
    means the card, which must be there; a test passes a CPU device."""
    import torch

    cell = core.Cell(args.workload, root)
    if device is None:
        device = cuda_device(cell.chips)
        kind = core.card(cell.chips)
    else:
        device = torch.device(device)
        kind = {"platform": device.type, "kind": device.type, "count": 1,
                "power_limit_w": None}
    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = SimpleNamespace(root=root, cell=cell, seed=args.seed,
                              seconds=args.seconds, device=device, t0=t0,
                              tracer=Tracer(bool(args.trace), scratch),
                              scratch=scratch)
        with open(os.path.join(scratch, "program.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            out = cell.loop().run(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    device_info = dict(kind, memory_peak_bytes=int(out.memory_peak))
    breakdown = None
    if args.trace:
        metrics = core.read_metrics(cell.per_layer, out.readers)
        if out.timeline is not None:
            device_info["busy_s"] = out.timeline.busy_s
            device_info["window_s"] = out.timeline.window_s
            breakdown = out.timeline.breakdown()
    else:
        metrics = {m["name"]: {"value": out.values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct = (core.judge(out.numbers, cell.limits) and out.failed == 0)
    lines = list(out.notes)
    if args.trace:
        lines.append(f"counters over the window {json.dumps(out.readers.counters)}")
    lines += core.check_lines(out.numbers, cell.limits)
    line = core.result_line(correct, out.attempted, out.failed, metrics,
                            device_info, out.numbers, cell.limits, breakdown)
    return line, lines


def main(argv=None) -> int:
    args = parse(argv)
    try:
        line, lines = execute(args)
    except NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 3
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
