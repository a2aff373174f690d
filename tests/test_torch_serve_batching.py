"""The port's micro-batching against dipole_tpu on JAX-CPU: the batched greedy,
the batched sign fix, the batched replay, orient_clouds_batched and
api.orient_simple_batch (identical signs and flips; acc within rtol 1e-4,
atol 1e-5; means within the potential parity test's tolerance), the replay
core's chunking under a small budget, the MicroBatcher's leader, drain and
error paths, and handlers.dispatch with a batcher."""
import random
import threading
import time

import numpy as np
import pytest
import torch

from dipole_tpu import api as japi
from dipole_tpu.ops import fields as jfields
from dipole_tpu.ops import propagate as jprop
from dipole_tpu.serve import batching as jbatching
from dipole_tpu.serve import handlers as jhandlers
from dipole_tpu_torch import api
from dipole_tpu_torch.ops import fields, propagate
from dipole_tpu_torch.serve import batching, handlers
from dipole_tpu_torch.serve.batching import MicroBatcher
from tests.conftest import make_sphere, scramble_signs

CPU = torch.device("cpu")


def _clouds(sizes=(150, 200, 170)):
    return [scramble_signs(make_sphere(n, seed=n), seed=n + 1)[0] for n in sizes]


def test_greedy_batched_matches_jax_and_the_column_tier():
    """Every lane runs the column greedy (JAX's vmapped on-the-fly scan):
    signs equal JAX's, acc within rtol 1e-4 (JAX-CPU contracts mul+add into
    FMA, the port does not), and bit-equal to the port's own column tier."""
    clouds = _clouds()
    got = propagate.greedy_sign_sequence_batched(clouds, device="cpu")
    want = jprop.greedy_sign_sequence_batched(clouds)
    assert len(got) == 3
    for pc, (acc, sign), (jacc, jsign) in zip(clouds, got, want):
        np.testing.assert_array_equal(sign, jsign)
        np.testing.assert_allclose(acc, jacc, rtol=1e-4, atol=1e-5)
        acc1, sign1 = propagate.greedy_sign_sequence(pc, matrix_limit=0, device="cpu")
        np.testing.assert_array_equal(acc, acc1.numpy())
        np.testing.assert_array_equal(sign, sign1.numpy())


def test_greedy_batched_starting_points_and_tiny_clouds():
    clouds = _clouds((120, 1, 90))
    starts = [17, 0, 89]
    got = propagate.greedy_sign_sequence_batched(clouds, starts, device="cpu")
    want = jprop.greedy_sign_sequence_batched(clouds, starts)
    for (acc, sign), (jacc, jsign) in zip(got, want):
        np.testing.assert_array_equal(sign, jsign)
        np.testing.assert_allclose(acc, jacc, rtol=1e-4, atol=1e-5)
    assert propagate.greedy_sign_sequence_batched([], device="cpu") == []
    with pytest.raises(ValueError):
        propagate.greedy_sign_sequence_batched(clouds, [0, 0, 90], device="cpu")


def test_mean_potential_batched_matches_jax_and_single():
    clouds = [make_sphere(n, seed=n) * 0.5 for n in (80, 120, 33)]
    got = fields.measure_mean_potential_batched(clouds, device="cpu")
    want = np.asarray(jfields.measure_mean_potential_batched(clouds))
    # the potential parity test's tolerance (tests/test_torch_fields.py)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    single = [fields.measure_mean_potential(pc, device="cpu") for pc in clouds]
    np.testing.assert_array_equal(got, np.float32(single))
    assert fields.measure_mean_potential_batched([], device="cpu").shape == (0,)


def _prepped(sizes, max_nn=10):
    out = []
    for n in sizes:
        pc, _ = handlers._prep(make_sphere(n, seed=n, noise=0.01)[:, :3], max_nn, CPU)
        out.append(pc)
    return out


@pytest.mark.parametrize("kernel", ["xie", "dipole"])
@pytest.mark.parametrize("diffuse", [False, True])
def test_xie_in_order_batched_matches_jax_and_single(kernel, diffuse):
    pcs = _prepped((90, 130, 110))
    orders = [propagate.bfs_orders(pc, 0, times=3)[0] for pc in pcs]
    orders[2] = orders[2][:, :70]                  # a shorter order set
    got = propagate.xie_in_order_batched(pcs, orders, diffuse=diffuse,
                                         kernel=kernel, device="cpu")
    want = jprop.xie_in_order_batched(pcs, orders, diffuse=diffuse, kernel=kernel)
    for pc, o, g, w in zip(pcs, orders, got, want):
        assert g.shape == (3, len(pc)) and g.dtype == bool
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, propagate.xie_propagation_in_order(
            pc, o, diffuse=diffuse, kernel=kernel, device="cpu"))


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("sizes", [(150, 200, 170), (160,)])
def test_orient_clouds_batched_matches_jax(diffuse, sizes):
    clouds = _clouds(sizes)
    got = propagate.orient_clouds_batched(clouds, diffuse=diffuse, device="cpu")
    want = jprop.orient_clouds_batched(clouds, diffuse=diffuse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_orient_simple_batch_matches_jax():
    clouds = [make_sphere(n, seed=n, noise=0.002)[:, :3] * 0.05 for n in (140, 180)]
    clouds.append(scramble_signs(make_sphere(120, seed=3), seed=4)[0])
    got = api.orient_simple_batch(clouds, diffuse=True, device="cpu")
    want = japi.orient_simple_batch(clouds, diffuse=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, :3], w[:, :3], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.sign(g[:, 3:6]), np.sign(w[:, 3:6]))
    one = api.orient_simple_batch(clouds[:1], diffuse=True, device="cpu")
    np.testing.assert_array_equal(one[0], api.orient_simple(clouds[0], diffuse=True,
                                                            device="cpu"))
    assert api.orient_simple_batch([], device="cpu") == []
    assert "orient_simple_batch" in api.__all__


def test_tree_xie_core_chunks_to_a_small_budget(monkeypatch):
    """A budget smaller than the batch cuts it into chunks (each cloud alone
    here, the first always admitted) with the same flips."""
    pcs = _prepped((90, 130, 100))
    payloads = [(pc, propagate.bfs_orders(pc, 0, times=3)[0], False, 3.0, CPU)
                for pc in pcs]
    whole = batching._tree_xie_core_batch(payloads)
    calls = []
    real = propagate.xie_in_order_batched

    def spy(pts_list, *a, **kw):
        calls.append(len(pts_list))
        return real(pts_list, *a, **kw)

    monkeypatch.setattr(propagate, "xie_in_order_batched", spy)
    monkeypatch.setattr(batching, "MAX_REPLAY_ENTRIES", 130 * 130 + 99)
    chunked = batching._tree_xie_core_batch(payloads)
    assert calls == [1, 1, 1]
    monkeypatch.setattr(batching, "MAX_REPLAY_ENTRIES", 90 * 90 + 130 * 130)
    calls.clear()
    assert all(np.array_equal(a, b) for a, b in
               zip(batching._tree_xie_core_batch(payloads), whole))
    assert calls == [2, 1]
    for a, b in zip(chunked, whole):
        assert a.shape == (len(b), 3)
        np.testing.assert_array_equal(a, b)


def test_microbatcher_coalesces_and_propagates_errors():
    b = MicroBatcher(window_s=0.05, max_batch=8)
    calls = []

    def runner(payloads):
        calls.append(list(payloads))
        return [p * 2 for p in payloads]

    results = {}

    def worker(i):
        results[i] = b.submit("sig", i, runner)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and sorted(calls[0]) == [0, 1, 2, 3]
    assert results == {0: 0, 1: 2, 2: 4, 3: 6}
    assert b.batches_run == 1 and b.jobs_run == 4

    def bad_runner(payloads):
        raise RuntimeError("boom")

    errors = []

    def bad_worker(i):
        try:
            b.submit("sig2", i, bad_runner)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=bad_worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == ["boom"] * 3


def test_microbatcher_stolen_leader_waits():
    """A draining leader of a previous batch may pop a new leader's job while
    the new leader is still in its window; the new leader must then wait for
    the thief's runner instead of returning an unset result."""
    b = MicroBatcher(window_s=0.0, max_batch=1)
    gate1, gate2 = threading.Event(), threading.Event()
    calls = []

    def runner(payloads):
        calls.append(list(payloads))
        (gate1 if len(calls) == 1 else gate2).wait(5.0)
        return [p * 10 for p in payloads]

    results = {}

    def submit_a():
        results["a"] = b.submit("s", 1, runner)

    def submit_b():
        b.window_s = 0.4          # long enough that A steals this job
        results["b"] = b.submit("s", 2, runner)

    ta = threading.Thread(target=submit_a)
    ta.start()
    time.sleep(0.1)
    tb = threading.Thread(target=submit_b)
    tb.start()
    time.sleep(0.1)
    gate1.set()
    time.sleep(0.1)
    gate2.set()
    ta.join(5.0)
    tb.join(5.0)
    assert results == {"a": 10, "b": 20}
    assert calls == [[1], [2]]


def test_microbatcher_drains_beyond_max_batch():
    b = MicroBatcher(window_s=0.1, max_batch=4)
    results = {}

    def worker(i):
        results[i] = b.submit("sig", i, lambda ps: [p * 10 for p in ps])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(11)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "stranded follower"
    assert results == {i: i * 10 for i in range(11)}
    assert b.jobs_run == 11


def test_microbatcher_fuzz_identity():
    """Many threads, several signatures, jittered arrivals, chunked drains:
    every submission gets exactly its own result."""
    b = MicroBatcher(window_s=0.005, max_batch=3)
    n_threads, n_rounds = 16, 12
    results, errors = {}, []

    def runner(payloads):
        time.sleep(0.002)
        return [p * 1000 + 1 for p in payloads]

    def worker(tid):
        r = random.Random(tid)
        try:
            for i in range(n_rounds):
                time.sleep(r.random() * 0.004)
                payload = tid * 1000 + i
                out = b.submit(("s", r.randrange(3)), payload, runner)
                assert out == payload * 1000 + 1, (tid, i, out)
            results[tid] = True
        except Exception as e:  # noqa: BLE001
            errors.append((tid, e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not errors, errors[:3]
    assert len(results) == n_threads
    assert b.jobs_run == n_threads * n_rounds


def test_microbatcher_runner_exception_reaches_all_waiters():
    b = MicroBatcher(window_s=0.05, max_batch=8)
    outcomes = {}

    def runner(payloads):
        if any(p < 0 for p in payloads):
            raise ValueError("poisoned batch")
        return [p + 1 for p in payloads]

    def worker(i, payload):
        try:
            outcomes[i] = ("ok", b.submit("sig", payload, runner))
        except ValueError as e:
            outcomes[i] = ("err", str(e))

    threads = [threading.Thread(target=worker, args=(i, -1)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert all(outcomes[i] == ("err", "poisoned batch") for i in range(4))
    assert b.submit("sig", 10, runner) == 11


def _concurrently(fn, n):
    outs = {}

    def run(i):
        outs[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    return outs


def test_tree_xie_dispatch_with_batcher_matches_serial_and_jax():
    """Three concurrent tree_xie requests (90, 90 and 130 points) through a
    batcher: each equals the port's serial handler and JAX's dispatch with
    its batcher; 3 replay jobs + 3 sign-fix jobs went through the batcher."""
    cfg = {"max_nn": 10, "eps": 1e-5, "diffuse": False, "times": 3}
    clouds = [make_sphere(n, seed=n)[:, :3].astype(np.float64) for n in (90, 90, 130)]
    serial = [handlers.dispatch("tree_xie_propagation", xyz, dict(cfg), device="cpu")
              for xyz in clouds]
    b = MicroBatcher(window_s=0.25, max_batch=8)
    got = _concurrently(lambda i: handlers.dispatch(
        "tree_xie_propagation", clouds[i], dict(cfg), batcher=b, device="cpu"), 3)
    jb = jbatching.MicroBatcher(window_s=0.25, max_batch=8)
    want = _concurrently(lambda i: jhandlers.dispatch(
        "tree_xie_propagation", clouds[i], dict(cfg), batcher=jb), 3)
    assert b.jobs_run == 6 and b.batches_run < b.jobs_run
    for i in range(3):
        np.testing.assert_array_equal(got[i], serial[i])
        # the same flips as JAX; the PCA normals themselves differ in float32
        # rounding (another summation order), up to 1e-3 here
        np.testing.assert_allclose(got[i][:, :3], want[i][:, :3], atol=1e-6)
        assert ((got[i][:, 3:] * want[i][:, 3:]).sum(1) > 0).all()
        np.testing.assert_allclose(got[i][:, 3:], want[i][:, 3:], atol=1e-3)


def test_simple_estimate_dispatch_with_batcher_keys_on_the_device(monkeypatch):
    """The signature names the device, so lanes on different devices never
    share a batch; the batched reply equals orient_clouds_batched on the
    prepared cloud."""
    sigs = []
    real = MicroBatcher.submit

    def spy(self, sig, payload, runner):
        sigs.append(sig)
        return real(self, sig, payload, runner)

    monkeypatch.setattr(MicroBatcher, "submit", spy)
    xyz = make_sphere(150, seed=9, noise=0.002)[:, :3].astype(np.float64) * 0.05
    b = MicroBatcher(window_s=0.0)
    got = handlers.dispatch("simple_estimate", xyz, {"diffuse": True}, batcher=b,
                            device="cpu")
    assert sigs == [("simple_estimate", True, "cpu")]
    pc, tr = handlers._prep(xyz, 30, CPU)
    want = tr.inverse(propagate.orient_clouds_batched([pc], diffuse=True,
                                                      device="cpu")[0])
    np.testing.assert_array_equal(got, want.astype(np.float64))
    # a masked tree_xie and the other handlers take the serial path
    cfg = {"max_nn": 10, "eps": 1e-2, "diffuse": False, "times": 3, "knn_mask": 8}
    out = handlers.dispatch("tree_xie_propagation", xyz, cfg, batcher=b, device="cpu")
    assert len(sigs) == 1 and out.shape == (150, 6)


def test_counters_are_exact_across_threads():
    """Handler threads bump the launch and plain-call counters concurrently:
    _build.bump loses no count (the server's kernels line adds them up)."""
    from dipole_tpu_torch.ops import _build

    counts = {"k": 0}

    def bump():
        for _ in range(20000):
            _build.bump(counts, "k")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts["k"] == 8 * 20000
