"""The port's servers on device="cpu": real TCP round trips against a live
server thread, the wire protocol against dipole_tpu's (its client against
the port's server and the port's client against its server, in one
process), admission control, the single-threaded server's self test and the
warm-up. Every socket binds port 0 on the loopback."""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from dipole_tpu.serve import protocol as jprotocol
from dipole_tpu.serve import server_para as jserver_para
from dipole_tpu_torch.ops import propagate
from dipole_tpu_torch.serve import handlers, protocol, server, server_para
from dipole_tpu_torch.serve.server_para import AdmissionControl, Server
from tests.conftest import make_sphere

XIE_CFG = {"max_nn": 10, "eps": 0.01, "diffuse": True, "times": 3, "knn_mask": -1,
           "C": 3}


def _free_port() -> int:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", srv.port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("server did not come up")


@pytest.fixture(scope="module")
def live_server(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("server_logs")
    srv = Server(host="127.0.0.1", port=_free_port(), log_dir=str(log_dir),
                 device="cpu")
    _start(srv)
    yield "127.0.0.1", srv.port, srv
    srv.stop()


def _sphere_xyz(n, seed, scale=0.05):
    # scaled inside the 0.1 hybrid-search radius (the estimator's fixed
    # radius is in raw input units, as in the reference)
    return make_sphere(n, seed=seed)[:, :3].astype(np.float64) * scale


def test_simple_estimate_roundtrip(live_server):
    host, port, _ = live_server
    xyz = _sphere_xyz(120, 0)
    out = protocol.request(host, port, "simple_estimate", xyz, {"diffuse": True})
    assert out.shape == (120, 6) and out.dtype == np.float64
    np.testing.assert_allclose(out[:, :3], xyz, atol=1e-6)
    assert (np.linalg.norm(out[:, 3:], axis=1) > 0.5).all()
    v = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    agree = ((out[:, 3:] * v).sum(1) > 0).mean()
    assert max(agree, 1 - agree) > 0.95


def test_hoppe_estimate_roundtrip(live_server):
    host, port, _ = live_server
    xyz = make_sphere(150, seed=1)[:, :3].astype(np.float64)
    out = protocol.request(host, port, "hoppe_estimate", xyz,
                           {"k_neighbor": 10, "r": 1.0})
    assert out.shape == (150, 6)
    want = handlers.dispatch("hoppe_estimate", xyz, {"k_neighbor": 10, "r": 1.0},
                             device="cpu")
    np.testing.assert_array_equal(out, want)
    v = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    agree = ((out[:, 3:] * v).sum(1) > 0).mean()
    assert max(agree, 1 - agree) > 0.95


def test_degenerate_input_returns_placeholder_normals(live_server):
    host, port, _ = live_server
    xyz = np.random.default_rng(0).normal(size=(5, 3))
    out = protocol.request(host, port, "tree_xie_propagation", xyz, XIE_CFG)
    assert out.shape == (5, 6)
    np.testing.assert_array_equal(out[:, :3], xyz)
    np.testing.assert_allclose(out[:, 3:], 1.0)


def test_unknown_function_errors(live_server):
    host, port, _ = live_server
    with pytest.raises(RuntimeError, match="server error"):
        protocol.request(host, port, "no_such_method", np.zeros((4, 3)), {})


def test_fragmented_header_is_reassembled(live_server):
    host, port, _ = live_server
    xyz = np.random.default_rng(1).normal(size=(5, 3)) * 0.05
    header = json.dumps({"data_size": len(xyz),
                         "function_name": "tree_xie_propagation",
                         "function_config": XIE_CFG}).encode()
    with socket.create_connection((host, port), timeout=60) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        mid = len(header) // 2
        s.sendall(header[:mid])
        time.sleep(0.3)                      # a separate segment
        s.sendall(header[mid:])
        assert json.loads(s.recv(protocol.REQUEST_BUFFER_SIZE))["status"] == "OK"
        s.sendall(np.ascontiguousarray(xyz, np.float64).tobytes())
        out = protocol.recv_exact(s, len(xyz) * 48)
    assert len(out) == len(xyz) * 48


def test_http_probe_fails_fast_and_server_stays_live(live_server):
    host, port, _ = live_server
    with socket.create_connection((host, port), timeout=10) as s:
        s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        t0 = time.time()
        reply = s.recv(protocol.REQUEST_BUFFER_SIZE)
        assert time.time() - t0 < 5.0
        assert json.loads(reply)["status"] == "ERROR"
    out = protocol.request(host, port, "simple_estimate", _sphere_xyz(60, 3),
                           {"diffuse": False})
    assert out.shape == (60, 6)


def test_concurrent_clients_agree(live_server):
    """4 concurrent simple_estimate clients through the micro-batching
    server: each reply equals the batched core (column lanes) on the same
    prepared cloud, or, for a lone request, orient_clouds_batched of one
    (the tiered greedy); both orient as the serial handler does."""
    host, port, srv = live_server
    assert srv.batcher is not None
    xyz = (make_sphere(120, seed=51)[:, :3]
           + np.random.default_rng(50).normal(scale=0.003, size=(120, 3))) * 0.05
    serial = handlers.dispatch("simple_estimate", xyz, {"diffuse": True}, device="cpu")
    pc, tr = handlers._prep(xyz, 30, torch.device("cpu"))
    lanes = tr.inverse(propagate.orient_clouds_batched([pc, pc], diffuse=True,
                                                       device="cpu")[0])
    alone = tr.inverse(propagate.orient_clouds_batched([pc], diffuse=True,
                                                       device="cpu")[0])
    for want in (lanes, alone):
        assert ((want[:, 3:] * serial[:, 3:]).sum(1) > 0).all()
    jobs0, batches0 = srv.batcher.jobs_run, srv.batcher.batches_run
    outs = {}

    def client(i):
        outs[i] = protocol.request(host, port, "simple_estimate", xyz, {"diffuse": True})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(outs) == 4 and srv.batcher.jobs_run - jobs0 == 4
    assert srv.batcher.batches_run - batches0 <= 4
    for out in outs.values():
        assert (np.array_equal(out, lanes.astype(np.float64))
                or np.array_equal(out, alone.astype(np.float64)))


def test_admission_control_rejects_oversized(tmp_path):
    ac = AdmissionControl(max_pts=100, log_dir=str(tmp_path))
    with pytest.raises(ValueError):
        ac.acquire(11)  # 121 > 100
    ac.acquire(10)
    ac.release(10)
    assert ac.res_pts == 100
    assert "quadratic-memory quota" in (tmp_path / "error.log").read_text()
    assert server_para.MAX_PTS == 30000 * 30000


def test_admission_control_queues():
    ac = AdmissionControl(max_pts=100, poll_s=0.05)
    ac.acquire(10)
    done = []

    def second():
        ac.acquire(10)
        done.append(True)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.15)
    assert not done  # still queued
    ac.release(10)
    t.join(timeout=2)
    assert done


def test_jax_client_against_the_port_server(live_server):
    """dipole_tpu's client speaks to the port's server unchanged."""
    host, port, _ = live_server
    xyz = _sphere_xyz(100, 7)
    out = jprotocol.request(host, port, "simple_estimate", xyz, {"diffuse": True})
    assert out.shape == (100, 6)
    np.testing.assert_allclose(out[:, :3], xyz, atol=1e-6)
    assert jprotocol.REQUEST_BUFFER_SIZE == protocol.REQUEST_BUFFER_SIZE
    assert jprotocol.BYTES_PER_POINT == protocol.BYTES_PER_POINT
    assert jprotocol.HEADER_TIMEOUT_S == protocol.HEADER_TIMEOUT_S
    with pytest.raises(RuntimeError):
        jprotocol.request(host, port, "no_such_method", np.zeros((4, 3)), {})


def test_port_client_against_the_jax_server(tmp_path):
    """The port's client speaks to dipole_tpu's threaded server unchanged."""
    srv = jserver_para.Server(host="127.0.0.1", port=_free_port(),
                              log_dir=str(tmp_path))
    _start(srv)
    try:
        xyz = _sphere_xyz(100, 8)
        out = protocol.request("127.0.0.1", srv.port, "hoppe_estimate", xyz,
                               {"k_neighbor": 10, "r": 1.0})
        assert out.shape == (100, 6)
        np.testing.assert_allclose(out[:, :3], xyz, atol=1e-6)
        with pytest.raises(RuntimeError):
            protocol.request("127.0.0.1", srv.port, "no_such_method",
                             np.zeros((4, 3)), {})
    finally:
        srv.stop()


def test_device_flag_and_mesh(tmp_path, monkeypatch):
    assert server_para.parse_device("1") == "cuda:1"
    assert server_para.parse_device("cuda:2") == "cuda:2"
    assert server_para.parse_device("cpu") == "cpu"
    assert Server(port=0, log_dir=str(tmp_path), device="cpu").device.type == "cpu"
    assert Server(port=0, log_dir=str(tmp_path), microbatch=False,
                  device="cpu").batcher is None
    # --mesh reaches the handlers: 4 CPU shards under --device cpu, and
    # more cards than exist raise ValueError, as in the JAX package
    monkeypatch.setattr(Server, "serve_forever", lambda self: None)
    try:
        server_para.main(["--device", "cpu", "--mesh", "4", "--port", "0",
                          "--log_dir", str(tmp_path)])
        assert handlers.get_mesh().size == 4 and handlers.get_mesh().type == "cpu"
        xyz = _sphere_xyz(100, 9)
        meshed = handlers.dispatch("simple_estimate", xyz, {}, device="cpu")
        handlers.set_mesh(None)
        np.testing.assert_array_equal(
            meshed, handlers.dispatch("simple_estimate", xyz, {}, device="cpu"))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        with pytest.raises(ValueError, match="available"):
            handlers.set_mesh(str(cards + 4))
    finally:
        handlers.set_mesh(None)


def test_single_threaded_server_self_test_and_round_trip():
    out = server.test_api(device="cpu", n=300)
    assert out.shape == (300, 6) and np.isfinite(out).all()
    np.testing.assert_allclose(out[:, :3], server.self_test_cloud(300), atol=1e-5)
    port = _free_port()
    threading.Thread(target=server.serve, args=("127.0.0.1", port, "cpu"),
                     daemon=True).start()
    deadline = time.time() + 10
    while True:
        try:
            xyz = _sphere_xyz(80, 11)
            got = protocol.request("127.0.0.1", port, "simple_estimate", xyz,
                                   {"diffuse": True})
            break
        except ConnectionRefusedError:
            assert time.time() < deadline
            time.sleep(0.05)
    want = handlers.dispatch("simple_estimate", xyz, {"diffuse": True}, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_warmup_runs_every_path_on_the_cpu(tmp_path):
    server_para.warmup([120], log_dir=str(tmp_path), device="cpu")
    log = (tmp_path / "info.log").read_text()
    for line in ("warmup simple_estimate n=120", "warmup tree_xie_propagation n=120",
                 "warmup simple_estimate batch B=8", "warmup tree_xie batch B=8"):
        assert line in log, log
    assert not (tmp_path / "warning.log").exists()
