"""Single-threaded TCP orientation server (reference socket_server.py) — the
port of dipole_tpu/serve/server.py.

Speaks the exact reference protocol (see serve/protocol.py); handles
simple_estimate and hoppe_estimate like the reference's single-thread server
(socket_server.py:62-114), plus the full handler set for convenience.
--self_test runs test_api (the reference's smoke run of simple_estimate,
socket_server.py:29-36) before serving, on a seeded cloud made here, not on
a data file.

    python -m dipole_tpu_torch.serve.server --port 12345 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import socket

import numpy as np

from dipole_tpu_torch.device import resolve_device
from dipole_tpu_torch.serve import protocol
from dipole_tpu_torch.serve.handlers import dispatch
from dipole_tpu_torch.serve.server_para import parse_device

HOST = "0.0.0.0"
PORT = 12345


def self_test_cloud(n: int = 2000, seed: int = 0) -> np.ndarray:
    """(n, 3) float64 points of an ellipsoid (axes 1, 0.7, 0.5), drawn from
    a numpy seed: the input of test_api."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * np.array([1.0, 0.7, 0.5])


def test_api(device="cuda", n: int = 2000, seed: int = 0) -> np.ndarray:
    """Orient self_test_cloud(n, seed) through simple_estimate; prints and
    returns the (n, 6) result."""
    result = dispatch("simple_estimate", self_test_cloud(n, seed),
                      {"diffuse": True}, device=device)
    print(result)
    return result


def serve(host=HOST, port=PORT, device="cuda"):
    dev = resolve_device(parse_device(device))
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen()
        print(f"Server listening on {host}:{port}")
        while True:
            conn, addr = s.accept()
            with conn:
                print(f"client connected: {addr}")
                try:
                    req, xyz = protocol.read_request(conn)
                    print(req)
                    result = dispatch(req["function_name"], xyz,
                                      req.get("function_config", {}), device=dev)
                    protocol.send_result(conn, result)
                except Exception as e:  # noqa: BLE001 — server must not die
                    print(f"Error: {e}")
                    protocol.send_error(conn)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=PORT)
    parser.add_argument("--host", type=str, default=HOST)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, cuda:N, an integer N (cuda:N) or cpu")
    parser.add_argument("--self_test", action="store_true")
    parser.add_argument("--mesh", type=str,
                        default=os.environ.get("DIPOLE_TPU_MESH"),
                        help="multi-device: device count or 'auto' (with "
                             "--device cpu, N CPU shards)")
    args = parser.parse_args(argv)
    if args.mesh:
        from dipole_tpu_torch.serve import handlers as _handlers

        _handlers.set_mesh(args.mesh, device=parse_device(args.device))
    if args.self_test:
        test_api(device=parse_device(args.device))
    serve(args.host, args.port, args.device)


if __name__ == "__main__":
    main()
