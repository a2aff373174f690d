"""Clouds with exact normals, made from a seed.

chip_smoke.py's `ellipsoid` sampler (chip_smoke.py:378), frozen here so that
a later change to chip_smoke.py cannot change what the benchmark feeds the
program, and made for many clouds in one call, twice: `ellipsoid_batch` with
torch on the card, for a batch cell's set-up (65 clouds of 180000 points in
0.5 s; numpy takes seconds), and `ellipsoid_points` with numpy alone, for the
open loop's client process, which keeps torch out so that its set-up stays
under the server's (with torch imported there a serve run's set-up read
16-25 s against 9-12 s).
"""
from __future__ import annotations

import numpy as np


def ellipsoid_batch(count: int, n: int, seed: int, axes=(1.0, 0.7, 0.5),
                    device="cpu") -> np.ndarray:
    """(count, n, 6) float32: `count` clouds of n points on the ellipsoid of
    semi-axes `axes`, with their analytic outward unit normals, drawn in one
    call from a torch.Generator on `device` seeded with `seed` (the same seed
    and device give the same clouds)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    v = torch.randn((count, n, 3), generator=gen, device=device, dtype=torch.float64)
    v = v / v.norm(dim=-1, keepdim=True)
    a = torch.tensor(axes, dtype=torch.float64, device=device)
    nrm = v / a
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    return torch.cat([v * a, nrm], dim=-1).to(torch.float32).cpu().numpy()


def ellipsoid_points(count: int, n: int, seed: int, axes=(1.0, 0.7, 0.5)) -> np.ndarray:
    """(count, n, 3) float64 positions on the ellipsoid of semi-axes `axes`,
    drawn in one call from numpy's generator seeded with `seed`."""
    v = np.random.default_rng(seed).normal(size=(count, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * np.asarray(axes, np.float64)
