"""The result line's schema, from a CPU run of each cell at a small size:
the keys the contract reads, the cell's metrics by name and unit, and the
compared numbers last."""
import json

import pytest
from helpers_pb import run_cpu, shrink

from portbench import core


@pytest.mark.parametrize("workload,traffic,seconds", [
    ("simple180k.batch", "closed.ellipsoid180k", 1.0),
    ("simple10k.serve", "open.ellipsoid10k", 2.0),
])
def test_result_line_schema(bench_root, monkeypatch, workload, traffic, seconds):
    from dipole_tpu_torch.serve import server_para

    monkeypatch.setattr(server_para, "warmup", lambda *a, **k: None)
    shrink(bench_root, traffic)
    cell = core.Cell(workload, root=bench_root)
    for trace in (0, 1):
        out, lines = run_cpu(bench_root, workload, seconds=seconds, trace=trace)
        assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(out)[-1] == "checks"
        assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
        assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert set(out["checks"]) == set(cell.limits)
        for name, c in out["checks"].items():
            assert c["value"] <= c["limit"]
        assert lines[-len(cell.limits):] == core.check_lines(
            {k: v["value"] for k, v in out["checks"].items()}, cell.limits)
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
            allowed = {m["name"]: m["unit"] for m in cell.per_layer}
        else:
            allowed = {m["name"]: m["unit"] for m in cell.end_to_end}
            assert set(out["metrics"]) == set(allowed)
        for name, m in out["metrics"].items():
            assert m["unit"] == allowed[name] and isinstance(m["value"], float)
        json.dumps(out, allow_nan=False)


def test_open_loop_summary_serves_what_came_in_the_window():
    """served_per_s counts the answers that came before the window closed,
    over the window's seconds; a failed request is not served and counts
    as late as the client gave up."""
    import numpy as np

    from portbench.loops.open_loop import summary

    data = {"latency": np.array([0.05, 0.07, 0.06, 3.0]),
            "ok": np.array([True, True, True, False]),
            "done": np.array([0.05, 1.07, 9.5, np.nan]),
            "lateness": np.array([1e-3, 2e-3, np.nan, 1e-3]),
            "seconds": np.float64(4.0)}
    s = summary(data)
    assert s["served_per_s"] == 2 / 4.0 and s["failed"] == 1 and s["attempted"] == 4
    assert s["latency_max_ms"] == 3000.0 and s["slowest_due_s"] is None
    assert s["latest_reply_s"] == 9.5
    data["done"] = np.array([0.05, 1.07, 2.5, np.nan])
    assert summary(data)["served_per_s"] == 3 / 4.0
    assert summary(data)["latency_p50_ms"] == 65.0
    data["ok"][3] = True
    data["done"][3] = 3.9
    assert summary(data)["slowest_due_s"] == 3.9 - 3.0
