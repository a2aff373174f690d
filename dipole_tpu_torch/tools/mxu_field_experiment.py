"""Tensor-core variants of the dipole field, timed against the field kernel.

The port of tools/mxu_field_experiment.py (the JAX package's prototype of
the field with its sums on the TPU's matrix unit):

  mxu_exact      the pair math (R, r^2, r, c, a, b) exactly as the field
                 kernel; the three output sums become one product per
                 512-source chunk, [b | a] (T, 2S) @ W (2S, 4),
                 W = [[p, 0], [-s, 1]], E += out[:, :3] + out[:, 3] t
  mxu_expansion  the same, with r^2 = t.t + s.s - 2 t.s and c = p.s - t.p
                 from two K=3 products (cancellation for near pairs), zero
                 test r^2 <= 0, r = sqrt(safe_r2)

On the card both run in csrc/field_mma.cu (3xTF32 mma.sync.m16n8k8: a and b
on the CUDA cores with csrc/field.cu's approximate roots, two products a
3xTF32 one; wgmma measured slower, PERF.md); "current" is
`ops.fields.field_grad`, csrc/field.cu. The tool prints GPairs/s of each
variant (best of 5 after one warm-up: CUDA events on the card, the host
clock on the CPU), then the relative max difference and the sign agreement
of E.n (random unit n) of each variant against "current":

    python -m dipole_tpu_torch.tools.mxu_field_experiment   # 65536 x 262144, the card
    python -m dipole_tpu_torch.tools.mxu_field_experiment --device cpu

On the CPU the full panel runs the plain versions six times each over
1.7e10 pairs; for a quick run call main(n_tgt=300, n_src=1000, device="cpu").

The outputs are not scrubbed: the expansion can give inf near a coincident
pair, and the tool reports what it gets.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dipole_tpu_torch.device import as_f32, resolve_device
from dipole_tpu_torch.ops import _build, fields, fields_cuda
from dipole_tpu_torch.ops.fields import sqrt_rn

__all__ = ["field_mxu_exact", "field_mxu_expansion", "field_mxu_exact_plain",
           "field_mxu_expansion_plain", "tolerance_scale", "tool_data", "main", "S_BLK",
           "PLAIN_CUDA_CALLS"]

# the prototype's sources per chunk product (dipole_tpu/ops/fields_pallas.py:33;
# its target block, T_BLK, is the TPU grid's and has no role here)
S_BLK = 512
EPS = 1e-5

PLAIN_CUDA_CALLS = {"field_mxu_exact": 0, "field_mxu_expansion": 0}


def _count_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        _build.bump(PLAIN_CUDA_CALLS, name)


def _ab(c, safe_r2, denom, zero):
    """a = 3 c t1 and b = safe_r2 t1, t1 = 1 / (safe_r2 denom); 0 where
    `zero`."""
    t1 = 1.0 / (safe_r2 * denom)
    a = torch.where(zero, torch.zeros_like(t1), 3.0 * c * t1)
    b = torch.where(zero, torch.zeros_like(t1), safe_r2 * t1)
    return a, b


def _chunk_sum(a, b, sc, tx3):
    """out4 = [b | a] @ W for one chunk, then out4[:, :3] + out4[:, 3] t."""
    ab = torch.cat([b, a], dim=1)                               # (T, 2S)
    ones = torch.ones((sc.shape[0], 1), dtype=sc.dtype, device=sc.device)
    W = torch.cat([torch.cat([sc[:, 3:6], torch.zeros_like(ones)], 1),
                   torch.cat([-sc[:, 0:3], ones], 1)], 0)       # (2S, 4)
    out4 = ab @ W
    return out4[:, :3] + out4[:, 3:4] * tx3


def field_mxu_exact_plain(sources: torch.Tensor, targets: torch.Tensor,
                          eps: float = EPS) -> torch.Tensor:
    """Plain torch version of _field_kernel_mxu_exact (prototype :26-64),
    term for term, one S_BLK chunk at a time. sources (M, 6), targets
    (T, 3) float32 -> E (T, 3), not scrubbed."""
    _count_plain("field_mxu_exact", sources)
    tx3 = targets[:, :3]
    tx, ty, tz = tx3[:, 0:1], tx3[:, 1:2], tx3[:, 2:3]
    acc = torch.zeros((targets.shape[0], 3), dtype=torch.float32,
                      device=targets.device)
    for off in range(0, sources.shape[0], S_BLK):
        sc = sources[off:off + S_BLK]
        px, py, pz = sc[:, 3], sc[:, 4], sc[:, 5]
        Rx = sc[:, 0] - tx
        Ry = sc[:, 1] - ty
        Rz = sc[:, 2] - tz
        r2 = Rx * Rx + Ry * Ry + Rz * Rz
        zero = r2 == 0.0
        r = sqrt_rn(r2)
        denom = r * r2 + eps
        c = px * Rx + py * Ry + pz * Rz
        safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
        a, b = _ab(c, safe_r2, denom, zero)
        acc = acc + _chunk_sum(a, b, sc, tx3)
    return acc


def field_mxu_expansion_plain(sources: torch.Tensor, targets: torch.Tensor,
                              eps: float = EPS) -> torch.Tensor:
    """Plain torch version of _field_kernel_mxu_expansion (prototype
    :67-105), term for term, one S_BLK chunk at a time, t.s and t.p by
    torch.matmul. sources (M, 6), targets (T, 3) float32 -> E (T, 3), not
    scrubbed."""
    _count_plain("field_mxu_expansion", sources)
    tx3 = targets[:, :3]
    t2 = torch.sum(tx3 * tx3, dim=1, keepdim=True)             # (T, 1)
    acc = torch.zeros((targets.shape[0], 3), dtype=torch.float32,
                      device=targets.device)
    for off in range(0, sources.shape[0], S_BLK):
        sc = sources[off:off + S_BLK]
        s3, p3 = sc[:, 0:3], sc[:, 3:6]
        s2 = torch.sum(s3 * s3, dim=1)                          # (S,)
        ps = torch.sum(p3 * s3, dim=1)
        ts = tx3 @ s3.t()                                       # (T, S)
        tp = tx3 @ p3.t()
        r2 = t2 + s2 - 2.0 * ts
        c = ps - tp
        zero = r2 <= 0.0
        safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
        r = sqrt_rn(safe_r2)
        denom = r * safe_r2 + eps
        a, b = _ab(c, safe_r2, denom, zero)
        acc = acc + _chunk_sum(a, b, sc, tx3)
    return acc


def tolerance_scale(sources: torch.Tensor, targets: torch.Tensor,
                    eps: float = EPS) -> torch.Tensor:
    """S_t = sum_s (|b| |p| + |a| (|s| + |t|)) per target (T,), float64:
    the size of the terms the variants sum, the scale of their tolerance
    (sums in other orders, TF32 splits, the expansion's cancellation)."""
    src = sources.double()
    tgt = targets[:, :3].double()
    tn = torch.linalg.norm(tgt, dim=1, keepdim=True)
    out = torch.zeros(tgt.shape[0], dtype=torch.float64, device=tgt.device)
    for off in range(0, src.shape[0], S_BLK):
        sc = src[off:off + S_BLK]
        R = sc[None, :, :3] - tgt[:, None, :]
        r2 = (R * R).sum(-1)
        zero = r2 == 0.0
        c = (sc[None, :, 3:6] * R).sum(-1)
        safe_r2 = torch.where(zero, torch.ones_like(r2), r2)
        denom = torch.sqrt(safe_r2) * safe_r2 + eps
        a = torch.where(zero, torch.zeros_like(c), 3.0 * c / (safe_r2 * denom))
        b = torch.where(zero, torch.zeros_like(c), 1.0 / denom)
        pn = torch.linalg.norm(sc[:, 3:6], dim=1)
        sn = torch.linalg.norm(sc[:, :3], dim=1)
        out += (b.abs() * pn + a.abs() * (sn + tn)).sum(1)
    return out


def _dispatch(kernel, plain, sources, targets, eps, device):
    dev = resolve_device(device)
    src = as_f32(sources, dev)[:, :6].contiguous()
    tgt = as_f32(targets, dev)[:, :3].contiguous()
    if dev.type == "cpu":
        return plain(src, tgt, eps)
    return kernel(src, tgt, eps)


def field_mxu_exact(sources, targets, eps: float = EPS, device="cuda") -> torch.Tensor:
    """The exact variant's E (T, 3): csrc/field_mma.cu on the card, the
    plain version on the CPU."""
    return _dispatch(fields_cuda.field_mxu_exact, field_mxu_exact_plain,
                     sources, targets, eps, device)


def field_mxu_expansion(sources, targets, eps: float = EPS,
                        device="cuda") -> torch.Tensor:
    """The expansion variant's E (T, 3): csrc/field_mma.cu on the card, the
    plain version on the CPU."""
    return _dispatch(fields_cuda.field_mxu_expansion, field_mxu_expansion_plain,
                     sources, targets, eps, device)


def _best_seconds(fn, dev: torch.device, runs: int = 5):
    """(first call s, best of `runs` s, output) after one warm-up call."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
    return first, best, out


def tool_data(n_tgt: int, n_src: int):
    """(sources (n_src, 6), targets (n_tgt, 3), the generator) as the
    prototype makes them (prototype :128-132): normal * 0.3, unit moments,
    from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(n_src, 6)).astype(np.float32) * 0.3
    src[:, 3:] /= np.linalg.norm(src[:, 3:], axis=1, keepdims=True)
    tgt = rng.normal(size=(n_tgt, 3)).astype(np.float32) * 0.3
    return src, tgt, rng


def main(n_tgt: int = 65536, n_src: int = 262144, device="cuda") -> dict:
    """The prototype's experiment on one panel of n_tgt targets x n_src
    sources (its data, from np.random.default_rng(0)); prints its lines and
    returns {"device", "n_tgt", "n_src", "ms", "gpairs_per_s",
    "rel_max_diff", "sign_agreement"}."""
    dev = resolve_device(device)
    src, tgt, rng = tool_data(n_tgt, n_src)
    src_t, tgt_t = as_f32(src, dev), as_f32(tgt, dev)

    variants = {
        "current": lambda: fields.field_grad(src_t, tgt_t, EPS),
        "mxu_exact": lambda: field_mxu_exact(src_t, tgt_t, EPS, dev),
        "mxu_expansion": lambda: field_mxu_expansion(src_t, tgt_t, EPS, dev),
    }
    res = {"device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
           "n_tgt": n_tgt, "n_src": n_src, "ms": {}, "gpairs_per_s": {},
           "rel_max_diff": {}, "sign_agreement": {}}
    outs = {}
    for name, fn in variants.items():
        first, best, out = _best_seconds(fn, dev)
        outs[name] = out.cpu().numpy()
        gpairs = n_tgt * n_src / best / 1e9
        res["ms"][name] = best * 1e3
        res["gpairs_per_s"][name] = gpairs
        print(f"{name:15s}: {gpairs:8.1f} GPairs/s  (first call {first:.1f}s)")

    ref = outs["current"]
    for name in ["mxu_exact", "mxu_expansion"]:
        out = outs[name]
        denom = np.abs(ref).max()
        maxdiff = float(np.abs(out - ref).max() / denom)
        # sign of E.n agreement with random unit n per target
        nrm = rng.normal(size=(n_tgt, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        s_ref = np.sign((ref * nrm).sum(1))
        s_out = np.sign((out * nrm).sum(1))
        agree = float((s_ref == s_out).mean())
        res["rel_max_diff"][name] = maxdiff
        res["sign_agreement"][name] = agree
        print(f"{name:15s}: rel max diff {maxdiff:.2e}, "
              f"interaction-sign agreement {agree:.6f}")
    return res


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
