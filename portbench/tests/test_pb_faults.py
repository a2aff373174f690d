"""`correct` comes out false when the timed path is broken underneath, and
for the control (the reference in bfloat16 in the program's place). The
runs skip the harness's look for a card and drive the rest of a run on the
CPU at a small size; each fault is planted in the program by monkeypatch."""
import json

import numpy as np
import pytest
import torch
from helpers_pb import run_cpu, shrink

from portbench import control, core

BATCH = ("simple180k.batch", "closed.ellipsoid180k")
SERVE = ("simple10k.serve", "open.ellipsoid10k")


def _flip_one(out: np.ndarray) -> np.ndarray:
    out = np.array(out, copy=True)
    out[len(out) // 2, 3:6] *= -1
    return out


@pytest.fixture
def quiet_server(monkeypatch):
    from dipole_tpu_torch.serve import server_para

    monkeypatch.setattr(server_para, "warmup", lambda *a, **k: None)


def test_batch_answer_altered_where_produced(bench_root, monkeypatch):
    from dipole_tpu_torch.ops import propagate

    real = propagate.strongest_field_propagation_points
    monkeypatch.setattr(propagate, "strongest_field_propagation_points",
                        lambda *a, **k: _flip_one(real(*a, **k)))
    shrink(bench_root, BATCH[1])
    out, _ = run_cpu(bench_root, BATCH[0], seconds=1.0)
    assert out["correct"] is False
    assert out["checks"]["oriented_gap"]["value"] > out["checks"]["oriented_gap"]["limit"]


def test_serve_answer_altered_where_produced(bench_root, monkeypatch, quiet_server):
    from dipole_tpu_torch.ops import propagate

    real = propagate.orient_clouds_batched
    monkeypatch.setattr(propagate, "orient_clouds_batched",
                        lambda pcs, **k: [_flip_one(o) for o in real(pcs, **k)])
    shrink(bench_root, SERVE[1])
    out, _ = run_cpu(bench_root, SERVE[0], seconds=2.0)
    assert out["correct"] is False


def _half_the_batch(monkeypatch) -> list:
    """Plants the fault: the batched core orients the first half of each
    batch of two or more (rounded up) and hands the rest back as they came;
    a lone request is left whole. Returns the list of batch sizes seen."""
    from dipole_tpu_torch.ops import propagate

    real = propagate.orient_clouds_batched
    sizes = []

    def half(pcs, **k):
        sizes.append(len(pcs))
        keep = (len(pcs) + 1) // 2
        return list(real(pcs[:keep], **k)) + [np.array(p, np.float32) for p in pcs[keep:]]

    monkeypatch.setattr(propagate, "orient_clouds_batched", half)
    return sizes


def test_serve_half_the_batch_left_out(bench_root, monkeypatch, quiet_server):
    """Every request is checked here, and batches must have formed: the
    batch window is widened to 0.5 s, since a warm CPU may otherwise finish
    each request before the next one arrives."""
    sizes = _half_the_batch(monkeypatch)
    config = bench_root / "portbench" / "configs" / "simple_dipole.json"
    c = json.loads(config.read_text())
    c["server_para"]["microbatch_window_s"] = 0.5
    config.write_text(json.dumps(c))
    shrink(bench_root, SERVE[1], check_requests=8)
    out, _ = run_cpu(bench_root, SERVE[0], seconds=2.0)
    assert max(sizes) >= 2, sizes
    assert out["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_half_the_batch_left_out_fails_on_the_card_at_the_cells_size(
        card, monkeypatch, quiet_server, seed):
    """The serve cell as committed (its rate, cloud size and sample of
    replies checked) over a 20-s window, the fault planted."""
    from portbench import run

    sizes = _half_the_batch(monkeypatch)
    args = run.parse(["--workload", SERVE[0], "--seed", str(seed), "--seconds", "20",
                      "--trace", "0"])
    line, lines = run.execute(args)
    out = json.loads(line)
    print(sum(s >= 2 for s in sizes), len(sizes), lines[-2:], flush=True)
    assert sum(s >= 2 for s in sizes) > 0
    assert out["correct"] is False


@pytest.mark.parametrize("workload,traffic", [BATCH, SERVE])
def test_control_fails(bench_root, workload, traffic):
    shrink(bench_root, traffic)
    cell = core.Cell(workload, root=bench_root)
    dev = torch.device("cpu")
    numbers = control.control_numbers(cell, control.check_inputs(cell, 12345, 1.0, dev), dev)
    assert not core.judge(numbers, cell.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["simple180k.batch", "simple10k.serve"])
def test_control_fails_on_the_card_at_the_cells_size(card, workload):
    cell = core.Cell(workload)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        inputs = control.check_inputs(cell, seed, cell.run_seconds, card)
        assert not core.judge(control.control_numbers(cell, inputs, card), cell.limits)
