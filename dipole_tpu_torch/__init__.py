"""dipole_tpu_torch — the PyTorch/CUDA port of dipole_tpu for NVIDIA Hopper.

The JAX package `dipole_tpu` is the reference; this package sits beside it
and keeps its module paths and function names. It carries per-point
propagation (`api.orient_simple`, `python -m
dipole_tpu_torch.cli.orient_simple`) and the patch pipelines with the PointCNN
ensemble (`api.orient_patches`, `orient_large`, `transfer_orientation` and
the CLIs `orient_pointcloud`, `orient_large`, `dipole_api`,
`reference_orientation`) end to end; and the mirror-field ("xie") family:
`api.orient(method="xie"|"tree_xie"|"hoppe")`, the server's algorithm
handlers (`serve.handlers.dispatch`) and the patch-graph pipeline
(`pipelines.graph_dipole`, `python -m dipole_tpu_torch.cli.graph_dipole`);
and the reference-protocol TCP servers with micro-batching
(`python -m dipole_tpu_torch.serve.server_para`, `serve.server`;
`api.orient_simple_batch` is the in-memory form of the batching); PointCNN
training (`train.py`); multi-device execution on a one-process device mesh
(`parallel.sharding.Mesh`, every `mesh=` and `--mesh`); and the
visualization exports and analysis helpers (`vis.py`, `analysis.py`).

Ground rules:
  * No JAX. The package imports `torch`, never `jax`, and nothing of
    `dipole_tpu` (every `dipole_tpu.*` import runs `dipole_tpu/__init__.py`,
    which loads JAX). Host helpers the port needs are its own copies.
  * The card is the default device. Every public function and the CLI take
    `device` (default "cuda"); asking for "cuda" without a GPU raises, it
    never drops to the CPU on its own. Tests pass device="cpu".
  * Float32 throughout. TF32 is switched off here, where the package
    initialises, for matmul and cuDNN alike.
  * Every TPU (Pallas) kernel on the path is a hand-written CUDA kernel under
    `csrc/`, built with nvcc for sm_90a on first use into `_build/` (see
    `ops/_build.py`). Each kernel has a plain-torch version beside it; a
    wrapper takes the plain version only for a CPU tensor, and on a CUDA
    tensor launches the kernel or raises.
  * Decisions match the JAX package: the greedy sends ties to the lowest
    index, flips where acc < 0, and the diffuse re-vote keeps iff
    acc * sign > 0; kNN and FPS select as its scans do; the ensemble's FPS
    starts come from the same threefry keys (utils/prng.py).
  * Weights: the PointCNN checkpoints of `pre_trained_tpu/` load into
    `models.pointcnn.PointCNN` by their torch names, and
    `models.pointcnn.from_numpy_params` takes the JAX package's parameters.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def orient(points, method: str = "auto", models=(), **kwargs):
    """One-call in-memory orientation — see `dipole_tpu_torch.api.orient`."""
    from dipole_tpu_torch import api

    return api.orient(points, method=method, models=models, **kwargs)
