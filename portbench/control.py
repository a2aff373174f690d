"""The control of a cell's `correct`: the plain reference computed in
bfloat16 (the precision below the configuration's float32) put in the
program's place, on the inputs a run of the cell samples for its check,
and judged as a run judges the program.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 30]

Prints one JSON line a seed with the compared numbers and the cell's
limits; each seed must come out not correct. Runs on the card by default
(`--device cpu` for a small rehearsal). The benchmark's runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import core, samplers  # noqa: E402
from portbench.loops import open_loop_client  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def check_inputs(cell: core.Cell, seed: int, seconds: float, device) -> np.ndarray:
    """(L, N, 3+) inputs of the seed that a run of the cell checks."""
    t = cell.traffic
    if t["kind"] == "open_loop":
        xyz, _, picks = open_loop_client.requests(
            seed, float(t["rate_per_s"]), seconds, int(t["points"]), tuple(t["axes"]),
            int(t["check_requests"]))
        return xyz[picks]
    clouds = samplers.ellipsoid_batch(int(t["samples"]) + 1, int(t["points"]), seed,
                                      tuple(t["axes"]), device=device)
    return clouds[:int(t["check_calls"])]


def control_numbers(cell: core.Cell, inputs: np.ndarray, device) -> dict:
    """The compared numbers when the bfloat16 reference answers in the
    program's place, judged as a run judges the program."""
    entry = cell.entry()
    answers, _ = entry.reference_answers(cell.config, inputs, device, CONTROL_DTYPE)
    return entry.check(cell.config, inputs, list(answers), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = core.Cell(args.workload)
    device = torch.device(args.device)
    seconds = cell.run_seconds if args.seconds is None else args.seconds
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, check_inputs(cell, seed, seconds, device), device)
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": numbers,
                          "limits": cell.limits,
                          "correct": core.judge(numbers, cell.limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
