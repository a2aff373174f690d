"""The port's span recorder (utils/timing.py) on device="cpu": the API's
spans under one request, a live server's request-scoped spans and its
batches, an unbatched handler's, the server's log of them, the admission
poll, the clock against torch.profiler's Chrome trace, handler threads
under an all-threads profiler, the ring's bound, and the closure report of
tools/span_closure.py."""
import json
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from dipole_tpu_torch import api
from dipole_tpu_torch.serve import handlers, protocol
from dipole_tpu_torch.serve.server_para import AdmissionControl, Server, _span_lines
from dipole_tpu_torch.utils import timing
from tests.conftest import make_sphere
from tools import span_closure

SERVE_CHILDREN = ("serve.read", "serve.admission", "serve.estimate",
                  "serve.queue", "transform.inverse", "serve.reply")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(window_s, log_dir):
    """A live CPU server, once the connection that probed it (a request
    that fails to read) has closed its span; the ring is then cleared."""
    srv = Server(host="127.0.0.1", port=_free_port(), log_dir=str(log_dir),
                 microbatch_window_s=window_s, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    timing.clear_spans()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", srv.port), timeout=1).close()
            break
        except OSError:
            time.sleep(0.05)
    while time.time() < deadline:
        if any(s.name == "serve.request" for s in timing.spans()):
            timing.clear_spans()
            return srv, thread
        time.sleep(0.01)
    raise RuntimeError("server did not come up")


def _stop(srv, thread):
    srv.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _requests(port, count):
    """`count` simple_estimate requests sent at once from threads of their
    own; returns once the server's handler threads have closed their
    `serve.request` spans too (a reply reaches the client before its span
    closes)."""
    errors = []

    def send(i):
        xyz = make_sphere(150, seed=70 + i)[:, :3].astype(np.float64) * 0.05
        try:
            out = protocol.request("127.0.0.1", port, "simple_estimate", xyz,
                                   {"diffuse": True}, timeout=120)
            assert out.shape == (150, 6)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i,)) for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    deadline = time.time() + 10
    while sum(s.name == "serve.request" for s in timing.spans()) < count \
            and time.time() < deadline:
        time.sleep(0.01)


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_orient_simple_records_one_request_with_its_stages():
    timing.clear_spans()
    api.orient_simple(make_sphere(200, seed=42)[:, :3] * 0.3, device="cpu")
    got = timing.spans()
    roots = [s for s in got if s.name == "api.orient_simple"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.request == root.id
    assert got[-1] is root and all(s.request == root.id for s in got)
    by_name = {s.name: s for s in got}
    assert len(by_name) == len(got) == 8
    for name in ("estimate unoriented normals", "transform", "dipole propagation",
                 "global sign fix", "transform.inverse"):
        assert by_name[name].parent == root.id and _inside(by_name[name], root)
    stage = by_name["estimate unoriented normals"]
    for name in ("estimate.knn", "estimate.pca"):
        assert by_name[name].parent == stage.id and _inside(by_name[name], stage)
    assert by_name["estimate.knn"].end_ns <= by_name["estimate.pca"].start_ns
    assert timing.current_request() is None


def test_server_spans_share_each_requests_id_and_batches_list_them(tmp_path):
    window = 0.3
    srv, thread = _start(window, tmp_path)
    try:
        _requests(srv.port, 3)
    finally:
        _stop(srv, thread)
    got = timing.spans()
    by_id = {s.id: s for s in got}
    requests = [s for s in got if s.name == "serve.request"]
    assert len(requests) == 3 and all(s.request == s.id for s in requests)
    cores = [s for s in got if s.name == "serve.core"]
    listed = [r for c in cores for r in c.tags["requests"]]
    assert sorted(listed) == sorted(r.id for r in requests)
    assert len({c.tags["batch"] for c in cores}) == len(cores)
    leaders = 0
    for req in requests:
        mine = [s for s in got if s.request == req.id and s is not req]
        for name in SERVE_CHILDREN:
            hits = [s for s in mine if s.name == name]
            assert len(hits) == 1, (name, mine)
            s = hits[0]
            assert _inside(s, req)
            while s.parent != req.id:        # nests in its serve.request
                s = by_id[s.parent]
                assert s.request == req.id
        core = next(c for c in cores if req.id in c.tags["requests"])
        queue = next(s for s in mine if s.name == "serve.queue")
        assert queue.end_ns <= core.start_ns
        if core.request == req.id:           # this request's thread led the batch
            leaders += 1
            assert queue.end_ns - queue.start_ns >= window * 1e9
    assert leaders == len(cores) >= 1
    log = (tmp_path / "info.log").read_text()
    assert "spans of 3 requests, the oldest span counted at " in log
    assert "ring is full" not in log
    for name in ("serve.request",) + SERVE_CHILDREN:
        assert f"span {name}: 3 p50 " in log
    assert f"span serve.core: {len(cores)} p50 " in log
    report = span_closure.serve_closure(got)
    assert report["requests"] == 3 and report["ids_each_in_one_core"]
    assert 0.0 <= report["within_limit"] <= 1.0 and report["uncovered"]["n"] == 3
    assert "start -> serve.read" in report["gaps"]


def test_unbatched_handler_opens_the_batched_ones_spans():
    xyz = make_sphere(150, seed=3)[:, :3].astype(np.float64) * 0.05
    timing.clear_spans()
    with timing.span("serve.request", request=True) as req:
        out = handlers.dispatch("simple_estimate", xyz, {"diffuse": True},
                                device="cpu")
    assert out.shape == (150, 6)
    got = {s.name: s for s in timing.spans()}
    for name in ("serve.estimate", "transform.inverse"):
        assert got[name].parent == req.id and got[name].request == req.id
        assert _inside(got[name], req)
    assert got["serve.estimate"].end_ns <= got["transform.inverse"].start_ns


def _fake(i, name, start_ms, end_ms, parent=None, request=None, **tags):
    return SimpleNamespace(id=i, name=name, start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6), thread=1, parent=parent,
                           request=request, tags=tags)


def test_span_log_names_its_window_and_a_full_ring():
    spans = [_fake(1, "serve.request", 0, 10, request=1),
             _fake(2, "serve.read", 1, 2, parent=1, request=1),
             _fake(3, "serve.read", 1, 4, request=None)]       # warm-up: no request
    lines = _span_lines(spans, since_ns=0)
    assert lines[0].startswith("spans of 1 requests, the oldest span counted at ")
    assert lines[1:] == ["span serve.request: 1 p50 10.00 ms p95 10.00 ms max 10.00 ms",
                         "span serve.read: 1 p50 1.00 ms p95 1.00 ms max 1.00 ms"]
    assert _span_lines(spans, since_ns=1) == []
    full = spans + [_fake(4, "ring.fill", 0, 0)] * (timing.SPAN_RING - len(spans))
    assert "the span ring is full (65536 spans)" in _span_lines(full, since_ns=0)[0]


def test_closure_report_names_each_gap_by_its_neighbours():
    # request 1 leads batch 7 (its core a child of its request), request 4
    # follows it; request 4 wakes 3 ms after the core and is uncovered 3.5 ms
    spans = [_fake(1, "serve.request", 0, 20, request=1),
             _fake(2, "serve.read", 0.5, 2, parent=1, request=1),
             _fake(3, "serve.queue", 2, 5, parent=1, request=1),
             _fake(9, "serve.core", 5, 15, parent=1, request=1, batch=7,
                   requests=[1, 4]),
             _fake(5, "serve.reply", 15.2, 20, parent=1, request=1),
             _fake(4, "serve.request", 1, 22, request=4),
             _fake(6, "serve.queue", 1, 5, parent=4, request=4),
             _fake(7, "transform.inverse", 18, 21.5, parent=4, request=4),
             _fake(8, "serve.reply", 21.5, 22, parent=4, request=4),
             _fake(30, "estimate.knn", 14, 17, parent=31, request=31)]
    spans[-1].thread = 2                 # another request's kNN, 14-17 ms
    r = span_closure.serve_closure(spans, limit_ms=2.0)
    assert r["requests"] == 2 and r["ids_each_in_one_core"]
    assert r["within_limit"] == 0.5
    assert r["uncovered"]["max_ms"] == pytest.approx(3.0)
    assert r["uncovered"]["p50_ms"] in (pytest.approx(0.7), pytest.approx(3.0))
    gaps = r["gaps"]
    assert gaps["start -> serve.read"]["sum_ms"] == pytest.approx(0.5)
    assert gaps["serve.core -> serve.reply"]["sum_ms"] == pytest.approx(0.2)
    assert gaps["serve.core (its leader's) -> transform.inverse"]["sum_ms"] \
        == pytest.approx(3.0)
    assert list(r["gaps_of_requests_over_the_limit"]) == [
        "serve.core (its leader's) -> transform.inverse"]
    assert gaps["serve.core (its leader's) -> transform.inverse"]["under_knn_ms"] \
        == pytest.approx(2.0)
    assert gaps["serve.core -> serve.reply"]["under_knn_ms"] == pytest.approx(0.2)
    assert gaps["start -> serve.read"]["under_knn_ms"] == 0
    assert r["knn_share"] == pytest.approx(3 / 22)
    calls = [_fake(20, "api.orient_simple", 0, 100, request=20),
             _fake(21, "estimate unoriented normals", 1, 41, parent=20, request=20),
             _fake(22, "estimate.knn", 2, 30, parent=21, request=20),
             _fake(23, "estimate.pca", 30, 40, parent=21, request=20),
             _fake(24, "transform", 41, 45, parent=20, request=20),
             _fake(25, "dipole propagation", 45, 95, parent=20, request=20),
             _fake(26, "transform.inverse", 95, 99, parent=20, request=20)]
    b = span_closure.batch_closure(calls)
    assert b["calls"] == 1 and b["seconds_per_call"]["self"] == pytest.approx(0.002)
    assert b["knn_and_pca_of_estimate"] == pytest.approx(38 / 40)
    assert b["stages_and_self_of_root"] == pytest.approx(0.92)
    assert b["stages_transforms_and_self_of_root"] == pytest.approx(1.0)
    assert span_closure.batch_closure(calls, skip=1) is None
    assert span_closure.serve_closure(calls) is None


def test_blocked_admission_span_covers_the_poll():
    ac = AdmissionControl(max_pts=100, poll_s=0.05)
    ac.acquire(10)
    seen = {}

    def second():
        seen["thread"] = threading.get_native_id()
        ac.acquire(10)

    timing.clear_spans()
    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.15)
    ac.release(10)
    t.join(timeout=5)
    assert not t.is_alive()
    blocked = [s for s in timing.spans()
               if s.name == "serve.admission" and s.thread == seen["thread"]]
    assert len(blocked) == 1 and blocked[0].end_ns - blocked[0].start_ns >= 0.05e9
    assert blocked[0].request is None


def _trace(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def test_span_clock_is_the_profilers_trace_clock(tmp_path):
    timing.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("clock.outer"):
            time.sleep(0.02)
            with timing.span("clock.inner"):
                time.sleep(0.01)
    trace = _trace(prof, tmp_path / "trace.json")
    base = int(trace["baseTimeNanoseconds"])
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    for s in timing.spans():
        e = events[s.name]
        assert abs(float(e["ts"]) - (s.start_ns - base) / 1000) < 1000.0
        assert abs(float(e["dur"]) - (s.end_ns - s.start_ns) / 1000) < 1000.0


def test_handler_thread_spans_reach_an_all_threads_trace(tmp_path):
    srv, thread = _start(0.0, tmp_path)
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=config) as prof:
            _requests(srv.port, 1)
    finally:
        _stop(srv, thread)
    names = {e["name"] for e in _trace(prof, tmp_path / "trace.json")["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"serve.request", "serve.read", "serve.estimate", "serve.core",
            "serve.reply"} <= names


def test_ring_keeps_the_newest_spans_and_a_raising_span_closes():
    timing.clear_spans()
    with pytest.raises(ZeroDivisionError):
        with timing.span("ring.raises", request=True, k=1) as s:
            assert timing.current_request() == s.id
            1 / 0
    assert timing.current_request() is None
    assert timing.spans() == [s] and s.tags == {"k": 1} and s.end_ns >= s.start_ns
    for i in range(timing.SPAN_RING + 5):
        with timing.span("ring.fill", i=i):
            pass
    got = timing.spans()
    assert len(got) == timing.SPAN_RING
    assert got[0].tags["i"] == 5 and got[-1].tags["i"] == timing.SPAN_RING + 4
    with timing.span("ring.outer", request=True) as outer:
        with timing.span("ring.nested", request=True) as nested:
            pass
    assert nested.request == outer.id and nested.parent == outer.id
    timing.clear_spans()
    assert timing.spans() == []
