"""Warm a machine on first use — the port of dipole_tpu/utils/warmup.py.

The JAX package walks its program matrix once per machine to fill XLA's
persistent compile cache. torch has no such cache to fill: CUDA contexts and
library state live and die with each process. The one thing that outlives a
process is the nvcc build of the nine csrc/ libraries (ops/_build.py, cached
in the checkout under dipole_tpu_torch/_build/), so ensure_warm() builds
those on a machine with a card and does nothing else. DIPOLE_TPU_NO_AUTOWARM=1
skips it, as in the JAX package; the first kernel call then builds lazily.
"""
from __future__ import annotations

import os

import torch

__all__ = ["ensure_warm"]


def ensure_warm(quiet: bool = False, device="cuda") -> bool:
    """Build the kernel libraries that are missing. Returns True when they
    are ready; False when switched off, for a CPU device, or on a machine
    without CUDA (the CPU path has nothing to build)."""
    if (os.environ.get("DIPOLE_TPU_NO_AUTOWARM")
            or torch.device(device).type != "cuda"
            or not torch.cuda.is_available()):
        return False
    from dipole_tpu_torch.ops import _build

    if not quiet:
        print("dipole_tpu_torch: building the CUDA kernels that are missing "
              "(set DIPOLE_TPU_NO_AUTOWARM=1 to skip)", flush=True)
    _build.build_all()
    return True
