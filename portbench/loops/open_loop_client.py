"""The open loop's client, run in a process of its own so that its threads
never hold the server's interpreter lock. It speaks the reference fork's
wire protocol (socket_server_para.py: a JSON header, "OK", N x 3 float64 in,
N x 6 float64 out) and imports neither torch nor the program.

    python3 portbench/loops/open_loop_client.py --port P --seed S --rate R
        --seconds T --points N --function simple_estimate --config '{...}'
        --check K --drain D --out result.npz

Set-up makes round(R T) distinct ellipsoids from the seed, and
their arrival times: the exact quantiles of an exponential of rate R (the
gaps of a Poisson process, without its sampling noise), scaled to fill T,
in one fixed shuffled order. Every seed gets the same arrivals: with only
the gaps the same and their order drawn from the seed, runs of different
seeds differed far more than two runs of one seed. It prints READY and
waits for GO on standard input; then each request is sent at its due time
in a thread of its own, whatever is outstanding. At T it prints CLOSED, then
waits up to D seconds for the replies, writes the result and prints DONE.
A request's latency runs from when it was due; one that fails or never
comes counts as taking until the client gave up on it. Each reply's time
from GO is kept too (NaN where none came).
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import samplers  # noqa: E402

HEADER_BYTES = 1000


ORDER_SEED = 20261018   # the one shuffle of the gaps, the same for every run


def schedule(count: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): the gaps are exponential quantiles at
    (k + 1/2) / count, scaled to sum to `seconds`, in a fixed shuffle."""
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    gaps = gaps[np.random.default_rng(ORDER_SEED).permutation(count)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def requests(seed: int, rate: float, seconds: float, points: int, axes, check: int):
    """(xyz, due, picks) of one window: round(rate seconds) clouds (float64,
    as the protocol sends them), their due times, and the `check` request
    indices sampled for the reference."""
    count = max(1, int(round(rate * seconds)))
    xyz = samplers.ellipsoid_points(count, points, seed, axes)
    due = schedule(count, rate, seconds)
    picks = np.sort(np.random.default_rng([int(seed), 2]).choice(
        count, size=min(check, count), replace=False))
    return xyz, due, picks


def recv_exact(conn: socket.socket, size: int) -> bytes:
    parts, have = [], 0
    while have < size:
        chunk = conn.recv(min(size - have, 1 << 20))
        if not chunk:
            break
        parts.append(chunk)
        have += len(chunk)
    return b"".join(parts)


def request(port: int, function: str, config: dict, xyz: np.ndarray,
            timeout: float) -> np.ndarray:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        header = {"data_size": len(xyz), "function_name": function,
                  "function_config": config}
        s.sendall(json.dumps(header).encode())
        ok = json.loads(s.recv(HEADER_BYTES))
        if ok.get("status") != "OK":
            raise RuntimeError(f"server refused: {ok}")
        s.sendall(np.ascontiguousarray(xyz, dtype=np.float64).tobytes())
        out = recv_exact(s, len(xyz) * 48)
        if len(out) != len(xyz) * 48:
            raise RuntimeError(f"short or error reply: {out[:100]!r}")
        return np.frombuffer(out, dtype=np.float64).reshape(-1, 6)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    for name, kind in (("port", int), ("seed", int), ("rate", float),
                       ("seconds", float), ("points", int), ("check", int),
                       ("drain", float)):
        p.add_argument(f"--{name}", type=kind, required=True)
    p.add_argument("--function", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--axes", default="1.0,0.7,0.5")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    config = json.loads(args.config)
    axes = tuple(float(a) for a in args.axes.split(","))
    xyz, due, picks = requests(args.seed, args.rate, args.seconds,
                                        args.points, axes, args.check)
    count = len(due)
    sent = np.full(count, np.nan)
    done = np.full(count, np.nan)
    ok = np.zeros(count, bool)
    replies = {}
    lock = threading.Lock()

    def send(j: int) -> None:
        sent[j] = time.perf_counter() - t0
        try:
            out = request(args.port, args.function, config, xyz[j],
                          timeout=args.seconds + args.drain)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"request {j}: {e}", file=sys.stderr)
            return
        done[j] = time.perf_counter() - t0
        with lock:
            ok[j] = True
            if j in set_picks:
                replies[j] = out

    set_picks = set(int(j) for j in picks)
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        return 2
    t0 = time.perf_counter()
    threads = []
    for j in range(count):
        wait = due[j] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        t = threading.Thread(target=send, args=(j,), daemon=True)
        t.start()
        threads.append(t)
    wait = args.seconds - (time.perf_counter() - t0)
    if wait > 0:
        time.sleep(wait)
    print("CLOSED", flush=True)
    give_up = t0 + args.seconds + args.drain
    for t in threads:
        t.join(max(0.0, give_up - time.perf_counter()))
    gave_up = time.perf_counter() - t0
    with lock:
        latency = np.where(ok, done - due, gave_up - due)
        order = [int(j) for j in picks]
        np.savez(args.out, latency=latency, ok=ok.copy(), lateness=sent - due,
                 done=done.copy(), seconds=np.float64(args.seconds),
                 picks=np.asarray(order, np.int64),
                 have=np.asarray([j in replies for j in order]),
                 replies=np.stack([replies.get(j, np.full((args.points, 6), np.nan))
                                   for j in order]),
                 sent_xyz=xyz[order])
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
