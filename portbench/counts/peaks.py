"""NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, at the full 700 W
power limit) and the least time a piece of work can take on them.

Frozen copies of chip_smoke.py's PEAK_* constants and `bound_ms`
(chip_smoke.py:264-266, :450-456), in seconds.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12    # HBM3
PEAK_FLOPS_F32 = 67e12        # fp32, outside the tensor cores
PEAK_FLOPS_TF32 = 494.7e12    # dense TF32, the tensor cores


def bound_s(n_bytes: float, n_ops: float, n_tf32_ops: float = 0.0):
    """(least seconds, "bytes" or "operations"): the bytes over the memory
    rate against the fp32 operations on the CUDA cores and the TF32
    operations on the tensor cores, each over its peak (the two units run
    side by side)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = max(n_ops / PEAK_FLOPS_F32, n_tf32_ops / PEAK_FLOPS_TF32)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def share_pct(least_s: float, measured_s: float):
    """The least time as a percentage of the measured time, or None when
    nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
