"""The harness finds configurations, traffic mixes, cells and per-layer
metrics by the names in BENCHMARK.json, so a later change adds files and
entries and edits none."""
import json

from portbench import core


def test_every_cell_resolves_its_parts():
    spec = core.load_spec()
    for w in spec["workloads"]:
        cell = core.Cell(w["name"], spec=spec)
        assert cell.entry().__name__.startswith("portbench.entries.")
        assert cell.loop().__name__.startswith("portbench.loops.")
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(core.metric_reader(m["name"]))


def test_new_metric_traffic_and_cell_are_picked_up_without_edits(bench_root):
    """A new per-layer metric (a reader file), a new mix (a data file) and a
    new cell (a limits file), named only in BENCHMARK.json, are found."""
    pb = bench_root / "portbench"
    (pb / "metrics" / "calls.count.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    mix = json.loads((pb / "traffic" / "closed.ellipsoid180k.json").read_text())
    mix["points"] = 90000
    (pb / "traffic" / "closed.ellipsoid90k.json").write_text(json.dumps(mix))
    (pb / "cells" / "simple90k.batch.json").write_text(
        (pb / "cells" / "simple180k.batch.json").read_text())
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "simple90k.batch", "config": "simple_dipole",
                              "traffic": "closed.ellipsoid90k", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls.count", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "call_s",
                              "workloads": ["simple90k.batch"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.Cell("simple90k.batch", root=bench_root)
    assert cell.traffic["points"] == 90000
    assert [m["name"] for m in cell.per_layer] == ["calls.count"]
    ctx = type("Ctx", (), {"root": bench_root, "calls": 7})()
    assert core.read_metrics(cell.per_layer, ctx) == {
        "calls.count": {"value": 7.0, "unit": "calls"}}
    assert "calls.count" not in [m["name"] for m in core.Cell("simple180k.batch",
                                                             root=bench_root).per_layer]


def test_split_metric_names_share_their_quantitys_reader(bench_root):
    """idle_share.batch and idle_share.serve read with metrics/idle_share.py,
    and so would a later idle_share.<suffix>; a file of the whole name wins."""
    shared = core.metric_reader("idle_share", bench_root)
    for name in ("idle_share.batch", "idle_share.serve", "idle_share.train"):
        assert core.metric_reader(name, bench_root).__code__.co_code == shared.__code__.co_code
    (bench_root / "portbench" / "metrics" / "idle_share.train.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    assert core.metric_reader("idle_share.train", bench_root)(None) == 1.5


def test_reader_that_finds_nothing_is_left_out():
    ctx = type("Ctx", (), {"root": core.ROOT, "timeline": None, "work": {}, "calls": 0,
                           "stages": {}, "counters": {}, "window_s": 0.0})()
    spec = core.load_spec()
    assert core.read_metrics(spec["per_layer"], ctx) == {}


def test_benchmark_json_keeps_the_contract():
    """The shape rules of BENCHMARK.json that a file can be checked for."""
    import re

    spec = core.load_spec()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and spec["paths"] == ["portbench"]
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith("portbench/") and (core.ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        reports = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert len(reports) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in spec["per_layer"])
