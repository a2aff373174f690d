"""Wire protocol shared by the network servers and their clients — the port
of dipole_tpu/serve/protocol.py, byte for byte (pure host code; the port
keeps its own copy so that it imports nothing of the JAX package).

Exactly the reference's protocol (socket_server.py:62-114,
socket_server_para.py:137-195) so existing clients work unchanged:
  1. client sends a JSON header {"data_size": N, "function_name": str,
     "function_config": dict} (single recv, <= 1000 bytes)
  2. server replies {"status": "OK"}
  3. client streams N * 24 bytes of little-endian float64 xyz triples
  4. server replies with N * 48 bytes float64 (N x 6) oriented cloud,
     or a JSON {"status": "ERROR"} blob on failure.
"""
from __future__ import annotations

import json
import socket

import numpy as np

REQUEST_BUFFER_SIZE = 1000
BYTES_PER_POINT = 24  # 3 x float64
HEADER_TIMEOUT_S = 20.0  # bound on waiting for the JSON header to complete


def recv_exact(conn: socket.socket, size: int) -> bytes:
    buf = b""
    while len(buf) < size:
        chunk = conn.recv(size - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def read_request(conn: socket.socket):
    """Server side: header -> OK -> payload. Returns (request, xyz (N,3))."""
    req = json.loads(recv_exact_header(conn))
    conn.sendall(json.dumps({"status": "OK"}).encode())
    size = req["data_size"] * BYTES_PER_POINT
    data = recv_exact(conn, size)
    if len(data) != size:
        raise ValueError(
            f"Data size mismatch. Expected {size} bytes, received {len(data)}."
        )
    xyz = np.frombuffer(data, dtype=np.float64).reshape(-1, 3)
    return req, xyz


def recv_exact_header(conn: socket.socket) -> bytes:
    """Accumulate recv chunks until the buffer parses as one JSON document.

    TCP may legally fragment the header; a single recv() (what the reference
    does at socket_server_para.py:141) would drop such clients. Parsing as
    the stop condition keeps byte-compatibility: well-behaved clients send
    exactly one JSON object and no payload bytes until they see the OK.

    Two guards keep a bad client from wedging the accept loop: bytes that
    cannot be a JSON-object prefix (e.g. an HTTP probe) fail immediately,
    and a header that never completes times out after HEADER_TIMEOUT_S."""
    buf = b""
    prev_timeout = conn.gettimeout()
    conn.settimeout(HEADER_TIMEOUT_S)
    try:
        while len(buf) < REQUEST_BUFFER_SIZE:
            try:
                chunk = conn.recv(REQUEST_BUFFER_SIZE - len(buf))
            except socket.timeout:
                break
            if not chunk:
                break
            buf += chunk
            head = buf.lstrip()[:1]
            if head and head != b"{":
                break  # not this protocol; let the caller reply ERROR
            try:
                json.loads(buf)
                return buf
            except json.JSONDecodeError:
                continue
    finally:
        conn.settimeout(prev_timeout)
    return buf


def send_result(conn: socket.socket, result: np.ndarray) -> None:
    conn.sendall(np.ascontiguousarray(result, dtype=np.float64).tobytes())


def send_error(conn: socket.socket) -> None:
    try:
        conn.sendall(json.dumps({"status": "ERROR"}).encode())
    except OSError:
        pass


def request(host: str, port: int, function_name: str, xyz: np.ndarray,
            function_config: dict | None = None, timeout: float = 600.0) -> np.ndarray:
    """Client helper: send a cloud, receive the oriented (N, 6) result."""
    xyz = np.ascontiguousarray(np.asarray(xyz, dtype=np.float64)[:, :3])
    with socket.create_connection((host, port), timeout=timeout) as s:
        header = {
            "data_size": len(xyz),
            "function_name": function_name,
            "function_config": function_config or {},
        }
        s.sendall(json.dumps(header).encode())
        ok = json.loads(s.recv(REQUEST_BUFFER_SIZE))
        if ok.get("status") != "OK":
            raise RuntimeError(f"server refused: {ok}")
        s.sendall(xyz.tobytes())
        out = recv_exact(s, len(xyz) * 48)
        if len(out) != len(xyz) * 48:
            try:
                err = json.loads(out)
            except Exception:
                raise RuntimeError(f"short response: {len(out)} bytes")
            raise RuntimeError(f"server error: {err}")
        return np.frombuffer(out, dtype=np.float64).reshape(-1, 6)
