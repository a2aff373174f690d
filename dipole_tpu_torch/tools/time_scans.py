"""Times the greedy and the replay kernels at the shapes the serving and
orienting paths give them, on the card, and prints one JSON line.

  greedy_columns          one cloud, column mode: 10000 and 180000 points
  greedy_columns_batched  8 clouds of 10000 points in one launch
  replay                  3 orders over a 30000-point xie matrix, 9 orders
                          over a 10000-point one
  replay_batched          8 clouds of 10000 points, 3 orders each

Each time is the mean of `reps` calls after one warm-up, by CUDA events;
the data are random clouds and permutations from a seed (the greedy runs
exactly N - 1 steps and the replay S steps whatever the data). The line
names the package that was timed and the card with its power limit, so
that two versions of the package can be timed in turns on one card:

    python dipole_tpu_torch/tools/time_scans.py
    PYTHONPATH=path/to/other/checkout python dipole_tpu_torch/tools/time_scans.py
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _cloud(n: int, seed: int) -> np.ndarray:
    """(n, 6) float32: points on an ellipsoid with unit normals of random
    sign."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([1.0, 0.7, 0.5])
    normals = d / axes
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals *= r.choice([-1.0, 1.0], size=(n, 1))
    return np.concatenate([d * axes, normals], axis=1).astype(np.float32)


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(reps: int = 5) -> dict:
    import dipole_tpu_torch
    from dipole_tpu_torch.ops import fields, propagate_cuda

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.splitlines()[0]
    r = np.random.default_rng(0)
    ms = {}
    for n in (10000, 180000):
        pts = torch.as_tensor(_cloud(n, n), device=dev)
        ms[f"greedy_columns_{n}"] = _ms(lambda: propagate_cuda.greedy_columns(pts, 0, 1e-6),
                                        reps)
    clouds = [torch.as_tensor(_cloud(10000, 100 + b), device=dev) for b in range(8)]
    ms["greedy_columns_batched_8x10000"] = _ms(
        lambda: propagate_cuda.greedy_columns_batched(clouds, [0] * 8, 1e-6), reps)
    for n, T in ((30000, 3), (10000, 9)):
        I = fields.xie_interaction_matrix(torch.as_tensor(_cloud(n, n + 1), device=dev))
        orders = torch.as_tensor(np.stack([r.permutation(n) for _ in range(T)]), device=dev)
        ms[f"replay_{n}_T{T}"] = _ms(lambda: propagate_cuda.replay(I, orders), reps)
        del I
    mats = [fields.xie_interaction_matrix(c) for c in clouds]
    orders = [torch.as_tensor(np.stack([r.permutation(10000) for _ in range(3)]),
                              device=dev) for _ in clouds]
    ms["replay_batched_8x10000_T3"] = _ms(lambda: propagate_cuda.replay_batched(mats, orders),
                                          reps)
    out = {"package": dipole_tpu_torch.__file__, "card": card, "reps": reps, "ms": ms}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    main(parser.parse_args().reps)
