"""The six readers of the program's spans (source program_span), each fed a
ring of known spans: the value it reads, and None where its spans are
absent, where the window holds no call, and where the program keeps no
ring (an older commit)."""
from types import SimpleNamespace

import pytest

from portbench import core

MS = 1_000_000
SERVE = ("serve.estimate_ms", "serve.queue_ms", "serve.admission_wait_ms",
         "serve.core_ms")
BATCH = ("stage_s.knn", "stage_s.api_self")


def _span(sid, name, start_ms, end_ms, parent=None, request=None, **tags):
    return SimpleNamespace(id=sid, name=name, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), parent=parent, request=request,
                           thread=1, tags=tags)


def _call(root, t0, knn_ms, gap_ms=1.0):
    """One api.orient_simple call at t0 ms: estimate (knn, pca), transform,
    propagation, sign fix, transform.inverse, `gap_ms` between each and
    after the last child; ids root .. root + 7."""
    r, t = root, t0
    out = [_span(r + 1, "estimate unoriented normals", t, t + knn_ms + 10, r, r),
           _span(r + 2, "estimate.knn", t, t + knn_ms, r + 1, r),
           _span(r + 3, "estimate.pca", t + knn_ms, t + knn_ms + 10, r + 1, r)]
    t += knn_ms + 10 + gap_ms
    for k, (name, ms) in enumerate((("transform", 2), ("dipole propagation", 500),
                                    ("global sign fix", 5), ("transform.inverse", 1))):
        out.append(_span(r + 4 + k, name, t, t + ms, r, r))
        t += ms + gap_ms
    out.append(_span(r, "api.orient_simple", t0 - gap_ms, t, None, r))
    return out


def _batch_ring():
    """A warm-up call, then two window calls with a kNN of 200 and 100 ms."""
    return _call(100, 0.0, 900.0) + _call(200, 2000.0, 200.0) + _call(300, 3000.0, 100.0)


def _serve_ring():
    """A warm-up estimate (no request id), then three requests: 10 and 20
    share batch 0 (10 leads it), 30 runs alone in batch 1 after 30 ms of
    admission. Estimates 20, 25, 30 ms; queues 14, 4, 10 ms."""
    return [
        _span(1, "serve.estimate", 0, 50),
        _span(11, "serve.read", 100, 101, 10, 10),
        _span(12, "serve.admission", 101, 101, 10, 10),
        _span(13, "serve.estimate", 101, 121, 10, 10),
        _span(21, "serve.read", 105, 106, 20, 20),
        _span(22, "serve.admission", 106, 106, 20, 20),
        _span(23, "serve.estimate", 106, 131, 20, 20),
        _span(24, "serve.queue", 131, 135, 20, 20),
        _span(14, "serve.queue", 121, 135, 10, 10),
        _span(40, "serve.core", 135, 160, 10, 10, batch=0, requests=[10, 20]),
        _span(15, "serve.reply", 161, 162, 10, 10),
        _span(10, "serve.request", 100, 162, None, 10),
        _span(25, "serve.reply", 162, 163, 20, 20),
        _span(20, "serve.request", 105, 163, None, 20),
        _span(31, "serve.read", 300, 301, 30, 30),
        _span(32, "serve.admission", 301, 331, 30, 30),
        _span(33, "serve.estimate", 331, 361, 30, 30),
        _span(34, "serve.queue", 361, 371, 30, 30),
        _span(41, "serve.core", 371, 395, 30, 30, batch=1, requests=[30]),
        _span(35, "serve.reply", 398, 400, 30, 30),
        _span(30, "serve.request", 300, 400, None, 30),
    ]


@pytest.fixture
def ring(monkeypatch):
    """Puts a list of spans in the program's ring's place."""
    from dipole_tpu_torch.utils import timing

    def put(spans):
        monkeypatch.setattr(timing, "spans", lambda: list(spans))
    return put


def _read(name, calls):
    return core.metric_reader(name)(SimpleNamespace(calls=calls))


def test_batch_readers_take_the_window_calls(ring):
    ring(_batch_ring())
    assert _read("stage_s.knn", 2) == pytest.approx(0.150)
    assert _read("stage_s.knn", 1) == pytest.approx(0.100)
    assert _read("stage_s.knn", 3) == pytest.approx(0.400)     # the warm-up too
    # a root opens 1 ms before its first child, leaves 1 ms between its
    # children and closes 1 ms after the last: 6 ms of self time a call
    assert _read("stage_s.api_self", 2) == pytest.approx(0.006)


def test_api_self_counts_overlapping_children_once(ring):
    spans = [_span(2, "a", 10, 40, 1, 1), _span(3, "b", 20, 50, 1, 1),
             _span(4, "inner", 25, 30, 2, 1), _span(5, "c", 60, 120, 1, 1),
             _span(1, "api.orient_simple", 0, 100, None, 1)]
    ring(spans)
    assert _read("stage_s.api_self", 1) == pytest.approx((100 - 40 - 40) * 1e-3)


def test_serve_readers_take_the_window_requests(ring):
    ring(_serve_ring())
    assert _read("serve.estimate_ms", 3) == pytest.approx(25.0)
    assert _read("serve.admission_wait_ms", 3) == pytest.approx(10.0)
    assert _read("serve.queue_ms", 3) == pytest.approx((14 + 4 + 10) / 3)
    assert _read("serve.core_ms", 3) == pytest.approx((25 + 24) / 2)
    assert _read("serve.core_ms", 1) == pytest.approx(24.0)     # request 30 only
    assert _read("serve.estimate_ms", 1) == pytest.approx(30.0)


@pytest.mark.parametrize("name", SERVE + BATCH)
def test_readers_find_nothing_without_their_spans(ring, monkeypatch, name):
    ring(_serve_ring() if name in BATCH else _batch_ring())
    assert _read(name, 3) is None
    ring([])
    assert _read(name, 3) is None
    ring(_batch_ring() + _serve_ring())
    assert isinstance(_read(name, 2), float)
    assert _read(name, 0) is None
    from dipole_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert _read(name, 2) is None


def test_queue_and_admission_read_none_where_no_request_has_them(ring):
    ring([s for s in _serve_ring() if s.name not in ("serve.queue", "serve.admission")])
    assert _read("serve.queue_ms", 3) is None
    assert _read("serve.admission_wait_ms", 3) is None
    assert _read("serve.estimate_ms", 3) == pytest.approx(25.0)
