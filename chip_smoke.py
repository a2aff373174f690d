#!/usr/bin/env python3
"""Drive dipole_tpu_torch's main paths on one NVIDIA GPU and hold every CUDA
kernel of those paths against its plain torch version.

    python3 chip_smoke.py                # from the repository root, one GPU
    python3 chip_smoke.py --checks-only  # build + kernel checks, then stop

Phases, one JSON line each:
  1. device     name, count, nvidia-smi name and power limit; no CUDA -> fail
  2. build      nvcc of the ten dipole_tpu_torch/csrc/*.cu for sm_90a, and
                of field_mma.cu's one-pass control; seconds, ptxas registers
                and spills
  3. checks     each kernel against its plain version on the card:
                potential 1000 lattice targets x 180k sources (+ a lattice
                point coincident with a source: exactly 0 there), and at
                each edge of its chunk plan (1, 31, 32, 2048, 2049 and 180k
                sources at 1, 1000 and 1025 targets, the poisoned point at
                180k), tolerance |kernel - plain| <= 1e-4 |plain| + 1e-5
                max|plain| on every target (sums run in other orders);
                imatrix, targets = sources (the symmetric mode), at 1, 63,
                64, 65, 129, 3001 and 4096 points and a graph_dipole patch,
                with duplicates and a pair 1e-22 apart (0), eps 1e-6 and
                1e-2, then targets given, bit-equal; greedy row mode at 2000 and column
                mode at 20000 points from a nonzero start, and its launch
                shapes: a cloud whose second half duplicates its first
                (exact ties across blocks, state in registers and in global
                memory), both sides of the register cap (a private cap),
                of the one-block threshold and of a points-a-thread step,
                one block of 8 points a thread and above it; signs identical
                and acc bit-equal; the patch-pipeline kernels at quick sizes
                and their edge cases: field (a target on a source, duplicate
                sources; per component rtol 1e-4 + 1e-5 max|E|), group
                (weights, duplicate points, an empty group, ids outside the
                range, groups larger than a staged tile, 1500 one-point
                groups, G = 1, coincident points, 2049 targets, groups
                across the grid's chunks of 256 sources, the hand's 10000
                points x 40; |dF| <= 1e-4 sum|I| per entry), knn (sentinel rows,
                duplicates, cross shapes, k above the source count, 8192
                sources; and at the forward's five shapes exact distance
                ties, lattice points and a duplicated half, for k = 1, 16,
                20 and 32) and fps
                (ragged valid counts, sentinel rows, duplicates, fewer valid
                points than picks; at 1, 31, 32, 33, 308, 512, 513, 1024 and
                8192 points, each boundary of its block plan, with every
                point twice and all points equal, m = 1 and m > n; a start
                outside the patch makes the kernel trap, in a child
                process), knn and fps
                bit-equal; the xie slice's
                kernels: the xie matrix in both layouts (I and I^T) at 4096
                points (coincident pairs: n.n; a pair 1e-20 apart whose
                entry overflows: 0), 3001, 129 (two tiles and a point),
                C = 2.5 and targets != sources, bit-equal; the xie greedy at 2000, 10000 and 30000 points, a
                cloud whose second half duplicates its first (exact ties,
                on one block and across 6), both sides of its one-block
                limit, one block of 8 points a thread and a matrix with most
                entries 0 (and some -0), each with and without a k = 8 kNN
                mask, acc and sign bit-equal; the replay
                for 1, 3 and 9 orders, xie and dipole matrices, kNN mask and
                points_weight on and off, 1500 and 700 steps (no multiple
                of the 128-step block), and orders that repeat indices,
                orders shorter than N and orders over seven indices:
                identical decisions, recorded interactions within 1e-6 of
                sum |I w|;
                normal estimation's search (csrc/radius_knn.cu) at the main
                path's 180000 and 10000 points (k 30, radius 0.1) and on a
                lattice with exact ties at every slot, duplicates, a flat
                cloud, a line, equal points, a far outlier, one point,
                fewer points than k and radii that hold only the point or
                every point, for k = 1, 8, 16, 30, 33 and 64, bit-equal;
                the batched column greedy (the server's micro-batch) at
                B = 1, 2, 3 and 8, mixed sizes from one block to 30000
                points, the tie clouds beside others, and a batch cut into
                several launches, each lane bit-equal to the launch over its
                cloud alone and to the plain version; the batched replay at
                B = 1, 2, 3 and 8 clouds of unequal sizes with orders of
                unequal lengths (repeats, an empty set), xie and dipole,
                and 60 lanes (more than one blocked loop takes), each lane
                bit-equal to the replay of its cloud alone and deciding as
                the plain version;
                the diffuse replay and the diffuse xie, card against CPU;
                the tensor-core field variants (csrc/field_mma.cu) on the
                tool's data at 4096 x 3001 and 777 x 20000, per target
                within 1e-5 (exact) and 5e-5 (expansion) of S_t = sum_s
                (|b||p| + |a|(|s| + |t|)): the exact one with a target on a
                source (= the field of the other sources) and duplicate
                sources, the expansion where no pair is nearer than 0.02
                (near pairs cancel there, its documented behaviour); then
                both on the tool's own data at its full 65536 x 262144,
                exact within 1e-5 S_t, expansion (near pairs) 1e-3 S_t, the
                plain versions timed there. A control build of
                field_mma.cu with a one-pass TF32 output reduction must
                fail at least one check of each variant
  4. main path  api.orient_simple(device="cuda") on a 10000-point 6-column
                scrambled ellipsoid (matrix tier, diffuse) and a 180000-point
                3-column ellipsoid (normal estimation + column tier); launch
                counts reset just before each run and read just after; GT sign
                agreement >= 0.99; each path kernel launched, no plain version
                called on a CUDA tensor, the 180k run's one estimate on the
                card route (estimate.ROUTES); a 2000-point cloud gives the same
                signs on the card as on the CPU. Then the patch pipelines
                with the v1 checkpoints pre_trained_tpu/dipole_{0,1,2}.pt:
                api.orient_patches on a 10000-point metaball hand at the hand
                demo's flags (demos/hand.sh), api.orient_large on a
                180000-point metaball lion at the lion demo's flags
                (demos/lion.sh), api.transfer_orientation from the oriented
                hand to a 180000-point hand; stage seconds and GT sign
                agreement of each; the field, group, knn and fps kernels
                launched, no plain version called on a CUDA tensor. Then the
                xie slice on scrambled ellipsoids (xyz only, normals
                re-estimated as the server does): api.orient(method="xie")
                at 10000 points, method="tree_xie" (times 3) and "hoppe" at
                30000 (the server's admission cap), and graph_dipole `run`
                (grid, 10 parts) through its CLI on the 10000-point cloud
                written to a .ply; GT sign agreement >= 0.95 each; orient
                xie and tree_xie at 2000 points give the same signs on the
                card as on the CPU. Then the serve phase: the port's
                threaded server (serve/server_para.Server, micro-batching
                on, a 50 ms window, then a second server at its default
                10 ms) on a loopback port, on the card: 8
                concurrent simple_estimate clients (8 different scrambled
                10000-point ellipsoids, xyz only), then 8 concurrent
                tree_xie clients at 10000 points and one at 30000 (the
                admission cap); each wave at 50 ms coalesces (fewer batches
                than device jobs; at 10 ms they are reported) and launches
                the batched greedy or replay;
                simple_estimate replies equal orient_clouds_batched here on
                the same prepared clouds, GT agreement >= 0.99; tree_xie
                replies equal the serial handler, GT agreement >= 0.95; one
                line a wave: its wall seconds, the same requests through
                dispatch one after another, jobs per batch, p50 and max
                latency of a request. Then the train phase:
                train.train_on_clouds with the fixers' recipe A
                (tools/train_r6.py) at batch 16, bucket 512, pool 0.6, lr
                1e-3, 40 steps, on the 199 mined states of
                train_data/mined_states_r4.npz and the 10k metaball hand
                patched by patches_from_cloud: the loss history, the kNN
                and FPS launched, no plain call; before it the same step
                taken apart on a fresh model (host batch assembly, forward,
                backward, optimizer: the first step's seconds and the median
                of steps 5-39, one step's launches); one step traced
                (torch.profiler: idle share, top kernels); one loss and
                backward with the kernels against one with the plain kNN and
                FPS (loss within 1e-6 relative, each gradient within 1e-5 of
                its max |g|: the gathers' backward is an atomic index_add);
                the fixed 16 x 512 make_batch trained 60 steps at lr 3e-3
                must reach max(acc of the last 10) > min(0.95, base +
                0.15); save_state_dict -> PointCNN.from_files reloads logits
                bit-equal. Then the torch_rng phase: api.orient_patches on
                the 10k hand with the hand demo's flags and torch_rng=1,
                twice: identical outputs, GT agreement >= 0.9, every draw
                from the seed-1 stream, whose first 32 randint(1000) must be
                TORCH_RNG_FIRST_32 (the JAX package's, pinned by
                tests/test_torch_torch_rng.py). Then the tool `python -m
                dipole_tpu_torch.tools.mxu_field_experiment` through its
                main() at 65536 x 262144: GPairs/s of "current" (field.cu)
                and both tensor-core kernels, their rel max diff and sign
                agreement; each kernel launched, no plain version called
  5. timing     CUDA-event times of each kernel and its plain version at the
                main path's shapes, the bound of each (radius_knn at 180000
                and 10000 points, its search kernel also by the profiler,
                torch.cdist + torch.topk its yardstick); there the imatrix
                (10k) and the greedy (10k rows, 180k columns on the full
                grid) are held bit-equal to their plain versions too. The
                potential (1000 x 180k) and the imatrix (10k, and in its
                general mode) also by the profiler's kernel time, and both
                at one graph_dipole patch (the 10k run's patch nearest the
                mean size, 458 points: 1000 x 458 and 458^2), with their
                launches per call. The
                column greedy at 20k, 50k, 100k and 180k on its own grid,
                with the fit us a step = a + b N (a fit only: the grid
                grows with N); on the full grid (one block an SM) at 1, 2,
                4 and 8 points a thread, with the fit us a step = a + b P
                (a: the exchange and the block's reductions; b: the sweep
                of one point a thread); at 20480 points on 20 blocks up to
                one an SM (the exchange against the block count); one block
                against a grid from 1024 to 8192 points, both modes.
                The patch kernels at the main path's largest calls: field
                10000 sources x 180000 targets (transfer), the lion's
                138869 representatives x its 41131 other points
                (orient_large's rest-point re-vote) and one edge of the
                graph_dipole run (505 x 499), each with its launches per
                call and the profiler's kernel time, group over the
                lion's representatives and over the hand's 10000 points
                in its patches (with its launches per orient_patches
                call), knn and fps on the lion's first forward chunk,
                knn at each of the forward's five calls
                (self k = 20 at 512, 308 and 185 rows; the k = 16
                interpolations 308 <- 185 and 512 <- 308) with its launches
                per lion call, its plain version's and torch.topk's time
                and the profiler's kernel time, and the forward's second FPS
                (m1 -> m2 rows), both FPS also by the profiler's kernel
                time; field and group held to their plain
                versions, knn and fps bit-equal; kNN's library yardstick is
                one torch.topk over the precomputed distances. One PointCNN
                forward over that chunk is timed and traced (torch.profiler:
                device busy share, the kernels that take the most time).
                The xie slice's kernels at its shapes: the xie matrix at
                30000 (I) and 10000 (I^T), and at 30000 in its general
                mode (targets given, no mirror), the xie greedy at 10000, masked
                (k = 8) at 10000 and at 30000, and one block against a grid
                from 2048 to 8192 points, the
                replay of the tree_xie run's 3 BFS orders at 30000 and of 9
                orders (graph_dipole's vote count) at 10000, and one replay
                traced (torch.profiler: its bulk and decision kernels'
                device time, the device's idle share). The
                tensor-core kernels at the tool's shape: their ms from the
                tool's run and the profiler's device time, over field.cu's
                device time at the same panel, their plain versions' ms
                from the checks, their bounds counting the CUDA-core pair
                math at the fp32 peak against the 3xTF32 products at the
                TF32 peak. The batched entries at the waves' shape: one
                batched launch against B single launches at B = 2, 4 and 8
                clouds of 10000 points (the greedy; the replay with 3
                orders a cloud), the plain versions a lane after another at
                B = 8, the greedy's bound by operations with the full-grid
                fit's step floor beside it, the replay's by bytes
  6. mesh, vis  after the timing phases and the plain column greedy at
                180k (time_plain_greedy_columns: after its ~10 million
                launches the profiler's traces came back with no device
                kernel in them, so no profiled timing follows it): the mesh
                phase, on a virtual mesh Mesh([cuda:0] *
                4) (and on make_mesh() over the cards where there are
                several): field_grad_sharded (targets, sources, ring) at the
                transfer's 10000 x 180000 within the field's tolerance,
                potential_sharded (sources, ring) at 180000 x 1000 within
                the potential's, point_group_interaction_sharded at the
                lion's 138869 x 364 bit-equal, xie_in_order_sharded (xie,
                dipole) with 3 BFS orders at 10k (agreement >= 0.99),
                orient_simple on the 10k ellipsoid (equal to one device, GT
                >= 0.99), orient(method="tree_xie", times=3) at 30k
                (agreement >= 0.99, GT >= 0.95), orient_large on the lion
                (GT >= 0.95) and handlers.dispatch under set_mesh
                (simple_estimate equal to one device, GT >= 0.99; tree_xie
                GT >= 0.95); one line a run: seconds beside the one-device
                run, launches, no plain call; the sharded loops' us a step.
                Then the train_mesh phase: train_on_clouds recipe A at 16 x
                512 on the train phase's corpus under the virtual meshes
                Mesh([cuda:0] * 4, shape=(2, 2)) and (4, 1) (and make_mesh
                over the cards where there are several): one step against
                the one-device step (loss within 1e-5 relative, each
                gradient within 1e-4 of its max |g|); 10 steps on one device
                and on (2, 2), ms a step side by side (median of steps 3-9),
                kNN and FPS launches a step (one device's times the data
                rows), no plain call; the fixed-batch bar on (2, 2) and the
                reload of the (2, 2)-trained model, logits bit-equal.
                Then the vis phase: vis.draw_field_isosurface on the 10k
                hand at res 48 (potential, then |E|; each lattice within its
                kernel's tolerance of the plain version), plot_cross_section
                (the .ply export without matplotlib) and
                analysis.self_interaction_table over 8 of the oriented
                hand's patches in get_segs's layout (within 1e-3 of the
                CPU's)

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero before the
last line. The data is made from a seed with numpy. Nothing of JAX or of the
JAX package is imported.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20261016
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FLOPS_F32 = 67e12        # H100 SXM fp32, outside the tensor cores
PEAK_FLOPS_TF32 = 494.7e12    # H100 SXM dense TF32, the tensor cores
# arithmetic operations per pair / entry, counted from the kernels' formulas
# (add, sub, mul, div and sqrt one each)
OPS_POTENTIAL = 17
OPS_IMATRIX = 33
OPS_GREEDY_COLUMN = 37        # the column entry + the acc update and |acc|
OPS_GREEDY_ROW = 4            # the acc update and |acc|
OPS_FIELD = 33                # the pair terms and both sums
OPS_GROUP = OPS_IMATRIX + 1   # the entry and its sum
OPS_KNN = 9                   # d2 and at least one comparison per pair
OPS_FPS = 10                  # d2, the running minimum and the argmax
OPS_XIE = 31                  # the xie entry (common.cuh's xie_pair)
OPS_GREEDY_XIE = 4            # rate update (2), acc += rate, the compare
OPS_REPLAY = 2                # one multiply-add per entry and order
# the tensor-core field variants, per pair: the pair math left on the CUDA
# cores, and the products (x 3 passes of 3xTF32) on the tensor cores
OPS_MXU = {"field_mxu_exact": (21, 16), "field_mxu_expansion": (12, 28)}
TF32_PASSES = 3
MXU_SHAPE = (65536, 262144)   # the tool's panel, targets x sources
# per-target limits of the tensor-core variants against their plain versions,
# in units of S_t: the exact one everywhere, the expansion where no pair is
# nearer than MXU_APART; on the tool's data (near pairs, where the
# expansion's r^2 cancels) the expansion is held to MXU_RTOL_NEAR_PAIRS
MXU_RTOL = {"field_mxu_exact": 1e-5, "field_mxu_expansion": 5e-5}
MXU_RTOL_NEAR_PAIRS = 1e-3
MXU_APART = 0.02
# csrc/field_mma.cu built with its output reduction in one TF32 pass: the
# control that the limits above must reject
MXU_CONTROL = ROOT / "dipole_tpu_torch" / "_build" / "control" / "libfield_mma_1pass.so"
MODELS = [ROOT / "pre_trained_tpu" / f"dipole_{i}.pt" for i in range(3)]
# the reference's FPS-start stream after torch.manual_seed(1): its first 32
# randint(1000) draws (tests/test_torch_torch_rng.py holds them to the JAX
# package's TorchMT19937(1))
TORCH_RNG_FIRST_32 = (845, 139, 124, 368, 263, 313, 491, 341, 759, 432, 248, 249,
                      516, 943, 13, 340, 302, 721, 242, 716, 750, 493, 346, 204,
                      723, 676, 674, 652, 829, 254, 18, 996)
# launch counts of each main-path run, by its label
RUN_COUNTS: dict = {}
CARD: dict = {}               # the nvidia-smi name and power limit, for the timed lines

KERNELS = {
    "dipole_potential": ("dipole_tpu_torch/csrc/potential.cu",
                         "dipole_tpu/ops/fields_pallas.py:98"),
    "dipole_imatrix": ("dipole_tpu_torch/csrc/imatrix.cu",
                       "dipole_tpu/ops/fields_pallas.py:210"),
    "greedy_rows": ("dipole_tpu_torch/csrc/greedy.cu",
                    "dipole_tpu/ops/propagate.py:82"),
    "greedy_columns": ("dipole_tpu_torch/csrc/greedy.cu",
                       "dipole_tpu/ops/propagate_pallas.py:40"),
    "dipole_field": ("dipole_tpu_torch/csrc/field.cu",
                     "dipole_tpu/ops/fields_pallas.py:79"),
    "dipole_group": ("dipole_tpu_torch/csrc/group.cu",
                     "dipole_tpu/ops/fields_pallas.py:318"),
    "knn": ("dipole_tpu_torch/csrc/knn.cu",
            "dipole_tpu/ops/neighbors_pallas.py:77"),
    "fps": ("dipole_tpu_torch/csrc/fps.cu",
            "dipole_tpu/ops/neighbors_pallas.py:158"),
    "xie_imatrix": ("dipole_tpu_torch/csrc/imatrix.cu",
                    "dipole_tpu/ops/fields_pallas.py:234"),
    "greedy_xie": ("dipole_tpu_torch/csrc/greedy.cu",
                   "dipole_tpu/ops/propagate.py:509"),
    "replay": ("dipole_tpu_torch/csrc/replay.cu",
               "dipole_tpu/ops/propagate.py:649"),
    "field_mxu_exact": ("dipole_tpu_torch/csrc/field_mma.cu",
                        "tools/mxu_field_experiment.py:26"),
    "field_mxu_expansion": ("dipole_tpu_torch/csrc/field_mma.cu",
                            "tools/mxu_field_experiment.py:67"),
    "greedy_columns_batched": ("dipole_tpu_torch/csrc/greedy.cu",
                               "dipole_tpu/ops/propagate.py:213"),
    "replay_batched": ("dipole_tpu_torch/csrc/replay.cu",
                       "dipole_tpu/ops/propagate.py:861"),
    "radius_knn": ("dipole_tpu_torch/csrc/radius_knn.cu",
                   "none: dipole_tpu/ops/estimate.py's host KD-tree search"),
}
# the profiler's name of the dipole matrix's kernel
IMATRIX_KERNEL = "DipolePair"
LIBRARY_CALLS = {"knn": "torch.topk(d2, k, largest=False) on the precomputed d2",
                 "radius_knn": "torch.cdist + torch.topk(k, largest=False) in query "
                               "chunks of 4096, no radius mask"}

# metaball shapes (tools/make_shape.py's lion and a fixed hand): F = sum
# r^2/|x-c|^2, the surface F = iso, the GT normal -grad F
LION_BALLS = [
    ((0.0, 0.0, 0.0), 0.50), ((0.45, 0.02, 0.0), 0.46), ((-0.45, 0.0, 0.0), 0.44),
    ((0.85, 0.25, 0.0), 0.38), ((1.15, 0.55, 0.0), 0.30), ((0.95, 0.45, 0.0), 0.34),
    ((0.55, -0.55, 0.22), 0.20), ((0.55, -0.55, -0.22), 0.20),
    ((-0.60, -0.55, 0.22), 0.20), ((-0.60, -0.55, -0.22), 0.20),
    ((0.55, -0.95, 0.22), 0.16), ((0.55, -0.95, -0.22), 0.16),
    ((-0.60, -0.95, 0.22), 0.16), ((-0.60, -0.95, -0.22), 0.16),
    ((-0.95, 0.15, 0.0), 0.18), ((-1.2, 0.4, 0.0), 0.13),
]
# palm (2 x 3 balls), wrist, four finger chains and a thumb
HAND_BALLS = (
    [((-0.22 + 0.22 * ix, -0.05 + 0.16 * iy, 0.0), 0.175)
     for ix in range(3) for iy in range(2)]
    + [((0.0, -0.30, 0.0), 0.155), ((0.0, -0.48, 0.0), 0.135)]
    + [((-0.24 + 0.175 * f + 0.01 * (f - 1.5) * j, 0.24 + 0.095 * (j + 1),
         -0.012 * j * j), 0.062 * (1.0 - 0.04 * j))
       for f in range(4) for j in range(6)]
    + [((-0.36 - 0.07 * (j + 1), -0.02 + 0.07 * (j + 1), 0.02 + 0.012 * j),
        0.068 * (1.0 - 0.05 * j)) for j in range(4)])


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def ellipsoid(n: int, seed: int, axes=(1.0, 0.7, 0.5)) -> np.ndarray:
    """(n, 6) points on an ellipsoid with analytic outward unit normals."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = np.asarray(axes)
    nrm = v / a
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([v * a, nrm], axis=1).astype(np.float32)


def _metaball(x: np.ndarray, balls):
    F = np.zeros(len(x))
    G = np.zeros_like(x)
    for c, r in balls:
        d = x - np.asarray(c)
        d2 = np.maximum((d * d).sum(1), 1e-12)
        F += r * r / d2
        G += (-2.0 * r * r / (d2 * d2))[:, None] * d
    return F, G


def metaball_cloud(n: int, balls, iso: float, seed: int) -> np.ndarray:
    """(n, 6) points on the level set F = iso of a metaball field, with the
    outward GT normal -grad F / |grad F|: points started on each ball's own
    level sphere (balls picked by area) are projected by damped Newton steps
    along grad F, and those that did not converge are dropped."""
    rng = np.random.default_rng(seed)
    c = np.array([b[0] for b in balls])
    r = np.array([b[1] for b in balls])
    out, have = [], 0
    while have < n:
        m = int(1.3 * (n - have)) + 1000
        pick = rng.choice(len(balls), m, p=r ** 2 / (r ** 2).sum())
        v = rng.normal(size=(m, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        x = c[pick] + v * (r[pick] / np.sqrt(iso))[:, None]
        for _ in range(20):
            F, G = _metaball(x, balls)
            step = ((F - iso) / np.maximum((G * G).sum(1), 1e-12))[:, None] * G
            size = np.maximum(np.linalg.norm(step, axis=1, keepdims=True), 1e-12)
            x = x - step * np.minimum(1.0, 0.05 / size)
        F, G = _metaball(x, balls)
        ok = np.abs(F - iso) < 1e-6 * iso
        nrm = -G[ok] / np.linalg.norm(G[ok], axis=1, keepdims=True)
        out.append(np.concatenate([x[ok], nrm], axis=1))
        have += int(ok.sum())
    return np.concatenate(out)[:n].astype(np.float32)


def scramble(pc: np.ndarray, seed: int) -> np.ndarray:
    out = pc.copy()
    flip = np.random.default_rng(seed).random(len(pc)) < 0.5
    out[flip, 3:6] *= -1
    return out


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
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


def bound_ms(n_bytes: float, n_ops: float, n_tf32_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the bytes over the memory rate
    against the fp32 operations on the CUDA cores and the TF32 operations on
    the tensor cores, each over its peak (the two units run side by side)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_ops / PEAK_FLOPS_F32, n_tf32_ops / PEAK_FLOPS_TF32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timed(fn):
    """(milliseconds, result) of one call of fn, by CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def _potential_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst target's |got - want| over its tolerance: rtol 1e-4, plus
    a floor of 1e-5 max|phi| for targets outside the shape, where the
    double layer's sum nearly cancels (the sums run in other orders)."""
    tol = 1e-4 * want.abs() + 1e-5 * float(want.abs().max())
    if float(tol.max()) == 0.0:                 # every target exactly 0
        return 0.0 if torch.equal(got, want) else float("inf")
    return float(((got - want).abs() / tol).max())


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise CheckFailed("torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    print(smi.splitlines()[0], flush=True)
    CARD["nvidia_smi"] = smi.splitlines()[0]
    return info


def phase_build() -> None:
    from dipole_tpu_torch.ops import _build

    t0 = time.perf_counter()
    MXU_CONTROL.parent.mkdir(parents=True, exist_ok=True)
    control = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFIELD_MMA_OUTPUT_PASSES=1", "-o",
         str(MXU_CONTROL), str(_build.CSRC / "field_mma.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        paths = _build.build_all()
        out, _ = control.communicate(timeout=600)
    finally:
        if control.poll() is None:
            control.kill()
            control.wait()
    require(control.returncode == 0, f"nvcc of the field_mma control failed:\n{out}")
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
             for name, out in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": secs,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()},
          "ptxas": ptxas})


def phase_checks(cloud180: torch.Tensor, cloud10: np.ndarray) -> dict:
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.utils.io import gen_grid

    dev = cloud180.device
    errs = {}
    grid = torch.as_tensor(gen_grid(10), device=dev)
    # potential at 1000 lattice targets x 180k sources, plus a lattice point
    # coincident with a source; then each edge of the chunk plan: 1, 31, 32,
    # 2048, 2049 and 180k sources at 1 target, the lattice and the lattice
    # and 25 more points, the poisoned point at 180k
    extra = torch.as_tensor(np.random.default_rng(SEED).uniform(
        -1, 1, (25, 3)).astype(np.float32), device=dev)
    targets = {1: grid[555:556], 1000: grid, 1025: torch.cat([grid, extra])}
    n180 = len(cloud180)
    cases = [(n180, 1000, False)] + [(s, t, s == n180)
                                     for s in (1, 31, 32, 2048, 2049, n180)
                                     for t in (1, 1000, 1025)]
    for n_src, n_tgt, poisoned in cases:
        src = cloud180[:n_src].clone()
        tgt = targets[n_tgt]
        at = 555 if n_tgt > 1 else 0            # grid[555]'s index in tgt
        if poisoned:
            src[0, :3] = tgt[at]
        k = fields.potential(src, tgt)
        p = fields.potential_plain(src, tgt)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        worst = _potential_err(k, p)
        require(bool(torch.isfinite(k).all()), "potential: non-finite output")
        require(worst <= 1.0, f"potential: error {worst} x its per-target "
                              f"tolerance at {n_tgt} x {n_src}")
        if poisoned:
            require(float(k[at]) == 0.0 and float(p[at]) == 0.0,
                    f"potential: poisoned target {float(k[at])}, "
                    f"{float(p[at])} (want exactly 0)")
        errs["dipole_potential"] = max(errs.get("dipole_potential", 0.0), err)
        emit({"phase": "check", "kernel": "dipole_potential", "targets": n_tgt,
              "sources": n_src, "poisoned_target": poisoned, "max_abs_err": err,
              "median_abs_phi": float(p.abs().median()),
              "max_err_over_tol": worst})

    # interaction matrix, targets = sources: 1, 63, 64, 65, 129, 3001 and
    # 4096 points (about the 64-point tile) with duplicates and a pair
    # 1e-22 apart whose entries overflow (0), a graph_dipole patch, at the
    # greedy's and the replay's eps 1e-6 and at 1e-2; then targets given
    errs["dipole_imatrix"] = 0.0
    clouds = [torch.as_tensor(cloud10[:n], device=dev).clone()
              for n in (1, 63, 64, 65, 129, 3001, 4096)] + [_graph_dipole_patch(dev)]
    for pts in clouds:
        n, dup = len(pts), len(pts) // 16
        if n > 64:
            pts[n - dup:] = pts[:dup]
            pts[dup, :3] = 0.0
            pts[dup + 1, :3] = torch.tensor([1e-22, 0.0, 0.0])
        for eps in (1e-6, 1e-2):
            k = fields.dipole_interaction_matrix(pts, eps=eps)
            p = fields.dipole_interaction_matrix_plain(pts, pts, eps)
            torch.cuda.synchronize()
            errs["dipole_imatrix"] = max(errs["dipole_imatrix"], _equal(
                "dipole_imatrix", k, p, n=n, eps=eps, max_ulp=max_ulp(k, p)))
            require(bool((torch.diagonal(k) == 0).all()), "imatrix: diagonal not 0")
            if n > 64:
                require(float(k[dup, dup + 1]) == 0.0 and float(k[dup + 1, dup]) == 0.0
                        and bool((k[torch.arange(n - dup, n), torch.arange(dup)] == 0).all()),
                        "imatrix: coincident or overflowing pair not 0")
    tgt = torch.as_tensor(cloud10[5000:5333], device=dev) * 1.5
    for n in (1, 65, 4096):
        pts = torch.as_tensor(cloud10[:n], device=dev)
        errs["dipole_imatrix"] = max(errs["dipole_imatrix"], _equal(
            "dipole_imatrix", fields.dipole_interaction_matrix(pts, targets=tgt),
            fields.dipole_interaction_matrix_plain(tgt, pts, 1e-6), n=n,
            targets=len(tgt)))

    # greedy, row mode at 2000 and column mode at 20000, nonzero starts
    I = fields.dipole_interaction_matrix(
        torch.as_tensor(scramble(cloud10[:2000], SEED + 2000), device=dev))
    cols = torch.as_tensor(scramble(cloud180[:20000].cpu().numpy(), SEED + 20000),
                           device=dev)
    cases = [
        ("greedy_rows", 2000, 17, lambda: propagate_cuda.greedy_rows(I, 17),
         lambda: propagate.greedy_rows_plain(I, 17)),
        ("greedy_columns", 20000, 123,
         lambda: propagate_cuda.greedy_columns(cols, 123, 1e-6),
         lambda: propagate.greedy_columns_plain(cols, 123, 1e-6)),
    ]
    cases += _greedy_launch_cases(cloud10, dev)
    for name, n, start, kernel, plain, *what in cases:
        t0 = time.perf_counter()
        ka, ks = kernel()
        launch = propagate_cuda.last_launch()
        pa, ps = plain()
        torch.cuda.synchronize()
        err = float((ka - pa).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        emit({"phase": "check", "kernel": name, "n": n, "start": start,
              **(what[0] if what else {}), "launch": launch,
              "signs_identical": bool(torch.equal(ks, ps)),
              "acc_bit_equal": bool(torch.equal(ka, pa)),
              "acc_max_ulp": max_ulp(ka, pa), "max_abs_err": err,
              "seconds": time.perf_counter() - t0})
        require(torch.equal(ks, ps), f"{name}: signs differ ({what})")
        require(bool((ks.abs() == 1).all()), f"{name}: a sign is not +-1")
        require(torch.equal(ka, pa), f"{name}: acc not bit-equal ({what})")
        if what and what[0]["ties"]:
            h = n // 2
            require(torch.equal(ka[:h], ka[h:2 * h]),
                    f"{name}: the duplicated points' acc differ ({what})")
    errs["greedy_columns_batched"] = check_greedy_batched(cloud180, cloud10, dev)
    return errs


def check_greedy_batched(cloud180: torch.Tensor, cloud10: np.ndarray, dev) -> float:
    """The batched column greedy, each lane against the launch over its
    cloud alone and against the plain version, bit for bit: B = 1, 2, 3
    and 8; mixed sizes (one cloud on one block, others up to the server's
    30000-point cap); the tie clouds of _greedy_launch_cases (a duplicated
    half, each pair in two blocks) beside others; and a batch planned for 8
    SMs, cut into several launches (held to the single launches)."""
    from dipole_tpu_torch.ops import propagate, propagate_cuda

    def cloud(n, seed, ties=False):
        base = cloud10[:n] if n <= len(cloud10) else cloud180[:n].cpu().numpy()
        pc = scramble(base, seed)
        if ties:
            pc[n // 2:] = pc[:n // 2]
        return torch.as_tensor(pc, device=dev)

    cases = [("B=1", [2000], {}, True), ("B=2", [1500, 5000], {}, True),
             ("B=3", [300, 4096, 4097], {}, True),
             ("B=8", [900 + 100 * b for b in range(8)], {}, True),
             ("mixed sizes", [3000, 4097, 12000, 30000], {}, True),
             ("ties across blocks", [6000, 2500, 6000], {}, True),
             ("several launches", [10000, 9000, 6000, 1000], {"_sms": 4}, False)]
    for label, sizes, kw, with_plain in cases:
        pts = [cloud(n, SEED + 300 + b, ties=label.startswith("ties") and b != 1)
               for b, n in enumerate(sizes)]
        starts = [(13 * b + 7) % n for b, n in enumerate(sizes)]
        t0 = time.perf_counter()
        got = propagate_cuda.greedy_columns_batched(pts, starts, 1e-6, **kw)
        launches = propagate_cuda.last_launch()["launches"]
        single = [propagate_cuda.greedy_columns(p, s0, 1e-6) for p, s0 in zip(pts, starts)]
        plain = ([propagate.greedy_columns_plain(p, s0, 1e-6) for p, s0 in zip(pts, starts)]
                 if with_plain else [None] * len(pts))
        torch.cuda.synchronize()
        lanes = []
        for p, (a, sg), one, pl in zip(pts, got, single, plain):
            same = torch.equal(a, one[0]) and torch.equal(sg, one[1])
            same_plain = pl is None or (torch.equal(a, pl[0]) and torch.equal(sg, pl[1]))
            lanes.append({"n": len(p), "bit_equal_single": same,
                          "bit_equal_plain": same_plain if pl is not None else None})
            require(same and same_plain, f"greedy_columns_batched: lane of {len(p)} "
                                         f"points differs ({label})")
            require(bool((sg.abs() == 1).all()), "greedy_columns_batched: a sign is not +-1")
        if label.startswith("ties"):
            for (a, _), n in zip(got, sizes):
                h = n // 2
                require(n == 2500 or torch.equal(a[:h], a[h:]),
                        "greedy_columns_batched: the duplicated points' acc differ")
        emit({"phase": "check", "kernel": "greedy_columns_batched", "case": label,
              "sizes": sizes, "launches": launches, "lanes": lanes,
              "seconds": time.perf_counter() - t0})
        require((len(launches) > 1) == bool(kw), f"greedy_columns_batched: {launches}")
    return 0.0


def _greedy_launch_cases(cloud10: np.ndarray, dev) -> list:
    """The greedy's launch shapes against the plain version: a cloud whose
    second half duplicates its first (exact ties in |acc|, each pair in two
    blocks), both sides of the register cap (through the private cap: above
    it the state lives in global memory), of the one-block threshold, of a
    points-a-thread step and of one block's 8192 points."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda

    def rows(label, n, start=7, ties=False, **kw):
        pts = torch.as_tensor(scramble(cloud10[:n], SEED + n), device=dev)
        if ties:
            pts[n // 2:] = pts[:n // 2]
        I = fields.dipole_interaction_matrix(pts)
        return ("greedy_rows", n, start,
                lambda: propagate_cuda.greedy_rows(I, start, **kw),
                lambda: propagate.greedy_rows_plain(I, start),
                {"case": label, "ties": ties, **kw})

    def cols(label, n, start=7, ties=False, **kw):
        pts = torch.as_tensor(scramble(cloud10[:n], SEED + n + 1), device=dev)
        if ties:
            pts[n // 2:] = pts[:n // 2]
        return ("greedy_columns", n, start,
                lambda: propagate_cuda.greedy_columns(pts, start, 1e-6, **kw),
                lambda: propagate.greedy_columns_plain(pts, start, 1e-6),
                {"case": label, "ties": ties, **kw})

    thr = propagate_cuda.one_block_max_n("rows")
    thr_cols = propagate_cuda.one_block_max_n("columns")
    return [
        cols("ties across 6 blocks", 6000, ties=True, _blocks=6),
        cols("ties, state in global memory", 6000, ties=True, _blocks=6, _reg_cap=1),
        rows("ties across 6 blocks", 6000, ties=True, _blocks=6),
        cols("at the register cap", 5000, _reg_cap=5000),
        cols("above the register cap: global state", 5001, _reg_cap=5000),
        rows("above the register cap: global state", 5001, _reg_cap=5000),
        rows("one-block threshold", thr), rows("one-block threshold + 1", thr + 1),
        cols("one-block threshold", thr_cols),
        cols("one-block threshold + 1", thr_cols + 1),
        rows("1 point a thread on 4 blocks", 4096, _blocks=4),
        rows("2 points a thread on 4 blocks", 4097, _blocks=4),
        rows("one block, 8 points a thread", 8192, _blocks=1),
        cols("one block above 8192 points: global state", 8193, _blocks=1),
    ]

def _per_entry(name: str, got, want, scale, rtol: float, **info) -> float:
    """Require |got - want| <= rtol * scale entry by entry (scale 0: exact);
    emit the check line and return the max abs difference."""
    diff = (got - want).abs()
    worst = float((diff / (rtol * scale).clamp_min(1e-30)).max())
    err = float(diff.max())
    emit({"phase": "check", "kernel": name, "rtol": rtol, "max_abs_err": err,
          "max_err_over_tol": worst, **info})
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(worst <= 1.0, f"{name}: error {worst} x its tolerance")
    return err


def _field_scale(p: torch.Tensor) -> torch.Tensor:
    """Per-component tolerance scale of a field: |E| plus a floor of 0.1 of
    the largest |E| (as 1e-4 |E| + 1e-5 max|E|), for components that
    cancel."""
    return p.abs() + 0.1 * p.abs().max()


def _group_scale(pts: torch.Tensor, gid: torch.Tensor, G: int) -> torch.Tensor:
    """sum over group g of |I[i, j]|, the scale of the group kernel's
    tolerance (its sum runs in another order than the one-hot product)."""
    from dipole_tpu_torch.ops import fields

    keep = (gid >= 0) & (gid < G)
    onehot = torch.zeros((len(gid), G), dtype=torch.float32, device=pts.device)
    onehot[torch.nonzero(keep)[:, 0], gid[keep]] = 1.0
    rows = [fields.dipole_interaction_matrix_plain(pts[b:b + 1024], pts, 1e-5).abs()
            @ onehot for b in range(0, len(pts), 1024)]
    return torch.cat(rows, dim=0)


def _equal(name: str, got, want, **info) -> float:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float(torch.where(a == b, 0.0, (a.double() - b.double()).abs()).max())
              if a.numel() else 0.0 for a, b in zip(got, want))
    emit({"phase": "check", "kernel": name, "bit_equal": equal,
          "max_abs_err": err, **info})
    require(equal, f"{name}: not bit-equal to its plain version ({info})")
    return err


def _knn_case(r, dev, b, nd, ns, k, nsent, self_knn):
    src = r.normal(size=(b, ns, 3)).astype(np.float32)
    src[:, ns // 2:ns // 2 + ns // 8] = src[:, :ns // 8]       # duplicates
    if nsent:
        src[:, -nsent:] = 1.0e6
    dst = src.copy() if self_knn else r.normal(size=(b, nd, 3)).astype(np.float32)
    dst[:, -3:] = 1.0e6
    return torch.as_tensor(dst, device=dev), torch.as_tensor(src, device=dev)


# the PointCNN forward's five kNN calls (nd <- ns): the k = 20 self
# searches at 512, 308 and 185 rows and the k = 16 interpolations
KNN_FORWARD = ((512, 512), (308, 308), (185, 185), (308, 185), (512, 308))


def _knn_tie_cases(r, dev, b=4):
    """(label, dst, src) at each forward shape with exact distance ties:
    points of an 8^3 integer lattice (d2 exact small integers, many equal),
    and random points whose second half duplicates the first; the queries
    are the sources for a self search, else a shuffle of lattice points or
    of the duplicated cloud with more rows."""
    lat = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1)
    lat = lat.reshape(-1, 3).astype(np.float32)
    out = []
    for nd, ns in KNN_FORWARD:
        src = np.stack([lat[r.permutation(512)[:ns]] for _ in range(b)])
        dst = src if nd == ns else np.stack([lat[r.permutation(512)[:nd]]
                                             for _ in range(b)])
        out.append((f"lattice {nd} <- {ns}", dst, src))
        src = r.normal(size=(b, ns, 3)).astype(np.float32)
        src[:, ns - ns // 2:] = src[:, :ns // 2]
        dst = src if nd == ns else np.concatenate(
            [src, src[:, r.integers(0, ns, nd - ns)]], axis=1)
        out.append((f"duplicated half {nd} <- {ns}", dst, src))
    return [(label, torch.as_tensor(np.ascontiguousarray(d), device=dev),
             torch.as_tensor(np.ascontiguousarray(s), device=dev))
            for label, d, s in out]


def _fps_case(r, dev, b, n, m, kind="random"):
    pos = r.normal(size=(b, n, 3)).astype(np.float32)
    nv = r.integers(max(1, min(n, m // 4)), n + 1, b)
    nv[0] = max(1, min(n, m // 3))                           # fewer than m
    if n >= 30:
        pos[:, 20:30] = pos[:, :10]                          # duplicates
    if kind == "duplicates":                                 # every point twice
        pos[:, n - n // 2:] = pos[:, :n // 2]
    elif kind == "all equal":
        pos[:] = pos[:, :1]
    valid = np.arange(n)[None, :] < nv[:, None]
    pos[~valid] = 1.0e6
    starts = (r.integers(0, 1 << 30, b) % nv).astype(np.int32)
    return (torch.as_tensor(pos, device=dev), torch.as_tensor(valid, device=dev),
            torch.as_tensor(starts, device=dev))


def phase_checks_patch(dev) -> dict:
    """The patch-pipeline kernels against their plain versions at quick
    sizes and the edge cases of tests/test_pallas.py."""
    from dipole_tpu_torch.ops import fields, neighbors, neighbors_cuda

    errs = {}
    r = np.random.default_rng(SEED + 7)
    # field: duplicate sources, targets on and off the surface, one target
    # on a source (its pair contributes nothing)
    src = torch.as_tensor(ellipsoid(6000, SEED + 3), device=dev)
    src[5500:] = src[:500]
    tgt = ellipsoid(3000, SEED + 4)[:, :3]
    tgt[1500:] *= 1.3
    tgt = torch.as_tensor(tgt, device=dev)
    tgt[0] = src[10, :3]
    k = fields.field_grad(src, tgt)
    p = fields.field_grad_plain(src, tgt, 1e-5)
    errs["dipole_field"] = _per_entry("dipole_field", k, p, _field_scale(p), 1e-4,
                                      sources=6000, targets=3000)

    # group: weights, duplicate points, group 7 empty, ids outside [0, 50)
    pts = torch.as_tensor(ellipsoid(4000, SEED + 5), device=dev)
    pts[3800:] = pts[:200]
    w = torch.as_tensor(r.uniform(0.1, 1.0, 4000).astype(np.float32), device=dev)
    gid = torch.as_tensor(r.integers(0, 50, 4000), device=dev)
    gid[gid == 7] = 8
    gid[:30] = -1
    gid[30:40] = 50
    k = fields.point_group_interaction(pts, gid, 50, source_weights=w)
    wpts = pts.clone()
    wpts[:, 3:6] *= w[:, None]
    p = fields.point_group_interaction_plain(wpts, gid, 50, 1e-5)
    require(bool((k[:, 7] == 0).all()), "dipole_group: empty group not 0")
    errs["dipole_group"] = _per_entry("dipole_group", k, p, _group_scale(wpts, gid, 50),
                                      1e-4, points=4000, groups=50)
    for label, pts, gid, G in _group_cases(r, dev):
        k = fields.point_group_interaction(pts, gid, G)
        p = fields.point_group_interaction_plain(pts, gid, G, 1e-5)
        errs["dipole_group"] = max(errs["dipole_group"], _per_entry(
            "dipole_group", k, p, _group_scale(pts, gid, G), 1e-4, case=label,
            points=len(pts), groups=G))

    # knn: self with sentinel rows, cross, nearly all sentinel, k > ns, the
    # most sources; then exact ties at the forward's five shapes
    errs["knn"] = 0.0
    for b, nd, ns, k_, nsent, self_knn in [(5, 512, 512, 20, 40, True),
                                           (3, 308, 185, 16, 0, False),
                                           (2, 130, 200, 20, 190, False),
                                           (2, 64, 10, 16, 0, False),
                                           (2, 33, 20, 32, 0, False),
                                           (4, 1024, 1024, 20, 100, True),
                                           (2, 300, 8192, 20, 0, False)]:
        dst, srcs = _knn_case(r, dev, b, nd, ns, k_, nsent, self_knn)
        errs["knn"] = max(errs["knn"], _equal(
            "knn", neighbors.knn_with_dist(dst, srcs, k_),
            neighbors.knn_with_dist_plain(dst, srcs, k_),
            shape=[b, nd, ns], k=k_, sentinel_rows=nsent))
    for label, dst, srcs in _knn_tie_cases(r, dev):
        for k_ in (1, 16, 20, 32):
            errs["knn"] = max(errs["knn"], _equal(
                "knn", neighbors.knn_with_dist(dst, srcs, k_),
                neighbors.knn_with_dist_plain(dst, srcs, k_), case=label,
                shape=[dst.shape[0], dst.shape[1], srcs.shape[1]], k=k_))
    errs["fps"] = 0.0
    for b, n, m in [(8, 512, 308), (4, 308, 185), (3, 1024, 615), (2, 128, 77)]:
        pos, valid, starts = _fps_case(r, dev, b, n, m)
        errs["fps"] = max(errs["fps"], _equal(
            "fps", neighbors.fps_masked_batch(pos, valid, m, starts),
            neighbors.fps_masked_batch_plain(pos, valid, m, starts),
            shape=[b, n], m=m))
    # each boundary of the block plan (points a lane, warps a patch), exact
    # distance ties, m = 1 and m > n
    for n in (1, 31, 32, 33, 308, 512, 513, 1024, 8192):
        for kind in ("random", "duplicates", "all equal"):
            for m in (1, min(n, 300) * 6 // 10 + 1, n + 3 if n <= 1024 else 200):
                pos, valid, starts = _fps_case(r, dev, 4, n, m, kind)
                errs["fps"] = max(errs["fps"], _equal(
                    "fps", neighbors.fps_masked_batch(pos, valid, m, starts),
                    neighbors.fps_masked_batch_plain(pos, valid, m, starts),
                    shape=[4, n], m=m, case=kind, plan=neighbors_cuda.fps_plan(n)))
    # a start outside the patch on the card makes the kernel trap; that
    # spoils the CUDA context, so it is launched in a child
    for bad in (308, -1):
        code = ("import torch\n"
                "from dipole_tpu_torch.ops import neighbors_cuda\n"
                "pos = torch.zeros((3, 308, 3), device='cuda')\n"
                "valid = torch.ones((3, 308), dtype=torch.bool, device='cuda')\n"
                f"st = torch.tensor([0, {bad}, 5], dtype=torch.int32, device='cuda')\n"
                "neighbors_cuda.fps_masked_batch(pos, valid, 185, st)\n"
                "torch.cuda.synchronize()\n")
        run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        require(run.returncode != 0 and "unspecified launch failure" in run.stderr,
                f"fps: a start of {bad} outside the patch is not refused:\n"
                f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    return errs


def _group_cases(r, dev):
    """(label, pts, gid, G) edge cases of csrc/group.cu's design: groups
    larger than a staged tile, many one-point groups, G = 1, empty groups
    and ids outside [0, G), coincident points, targets not a multiple of a
    thread's or a block's, groups across the grid's chunks of 256 sources,
    the hand's shape (10000 points, ~40 groups)."""
    out = []

    def cloud(n, seed):
        return torch.as_tensor(ellipsoid(n, seed), device=dev)

    out.append(("larger than a tile", cloud(3000, SEED + 50), np.arange(3000) % 2, 2))
    out.append(("one-point groups", cloud(1500, SEED + 51), r.permutation(1500), 1500))
    out.append(("one group", cloud(5000, SEED + 52), np.zeros(5000, np.int64), 1))
    gid = r.integers(1, 39, 3000)
    gid[gid == 5] = 6
    gid[:100], gid[100:200] = -3, 40
    out.append(("empty and outside", cloud(3000, SEED + 53), gid, 40))
    pts = cloud(3000, SEED + 54)
    pts[2000:] = pts[:1000]
    out.append(("coincident points", pts, r.integers(0, 40, 3000), 40))
    out.append(("ragged targets", cloud(2049, SEED + 55), r.integers(0, 40, 2049), 40))
    sizes = [300, 0, 212, 256, 1, 255, 257, 0, 519] + [100] * 12
    gid = np.repeat(np.arange(len(sizes)), sizes)[r.permutation(3000)]
    out.append(("chunk edges", cloud(3000, SEED + 56), gid, len(sizes)))
    out.append(("hand shape", cloud(10000, SEED + 57), r.integers(0, 40, 10000), 40))
    return [(label, pts, torch.as_tensor(gid, device=dev), G) for label, pts, gid, G in out]


def _all_counts():
    from dipole_tpu_torch.ops import (fields, fields_cuda, neighbors,
                                      neighbors_cuda, propagate, propagate_cuda)
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    return ((fields_cuda.LAUNCHES, propagate_cuda.LAUNCHES, neighbors_cuda.LAUNCHES),
            (fields.PLAIN_CUDA_CALLS, propagate.PLAIN_CUDA_CALLS,
             neighbors.PLAIN_CUDA_CALLS, mxu.PLAIN_CUDA_CALLS))


def _reset_counts():
    launches, plain = _all_counts()
    for d in (*launches, *plain):
        for key in d:
            d[key] = 0


def _read_counts():
    launches, plain = _all_counts()
    return ({k: v for d in launches for k, v in d.items()},
            {k: v for d in plain for k, v in d.items()})


def phase_main_path(gt10: np.ndarray, gt180: np.ndarray) -> dict:
    from dipole_tpu_torch import api
    from dipole_tpu_torch.ops import estimate
    from dipole_tpu_torch.ops.metrics import sign_agreement
    from dipole_tpu_torch.utils.timing import timer_factory

    runs = [
        ("10k_6col_diffuse", scramble(gt10, SEED + 1), gt10, True,
         ("dipole_imatrix", "greedy_rows", "dipole_potential")),
        ("180k_3col", gt180[:, :3].copy(), gt180, False,
         ("radius_knn", "greedy_columns", "dipole_potential")),
    ]
    launches = {}
    for label, inp, gt, diffuse, path_kernels in runs:
        timer = timer_factory()
        torch.cuda.synchronize()
        _reset_counts()
        estimate.ROUTES.update(card=0, host=0)
        t0 = time.perf_counter()
        out = api.orient_simple(inp, diffuse=diffuse, timer=timer, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = _read_counts()
        routes = dict(estimate.ROUTES)
        RUN_COUNTS[label] = counts
        agree = sign_agreement(out, gt)
        outward = float(((out[:, 3:6] * gt[:, 3:6]).sum(1) > 0).mean())
        emit({"phase": "main_path", "run": label, "n": len(inp),
              "seconds": wall, "stages": timer.stages,
              "gt_sign_agreement": agree, "outward_fraction": outward,
              "launches": counts, "plain_cuda_calls": plain,
              "estimate_routes": routes})
        require(out.shape == (len(inp), 6) and bool(np.isfinite(out).all()),
                f"{label}: bad output")
        require(np.allclose(out[:, :3], gt[:, :3], atol=1e-4),
                f"{label}: positions moved")
        require(agree >= 0.99, f"{label}: GT sign agreement {agree} < 0.99")
        for name in path_kernels:
            require(counts[name] > 0, f"{label}: kernel {name} not launched")
            launches[name] = launches.get(name, 0) + counts[name]
        require(not any(plain.values()),
                f"{label}: plain version called on CUDA: {plain}")
        want_routes = {"card": int(inp.shape[1] == 3), "host": 0}
        require(routes == want_routes,
                f"{label}: estimate routes {routes}, expected {want_routes}")

    # the card against the CPU path on a small input
    small = scramble(gt10[:2000], SEED + 2)
    on_card = api.orient_simple(small, diffuse=True, device="cuda")
    on_cpu = api.orient_simple(small, diffuse=True, device="cpu")
    same = float(((on_card[:, 3:6] * on_cpu[:, 3:6]).sum(1) > 0).mean())
    emit({"phase": "main_path", "run": "2k_card_vs_cpu", "same_sign": same})
    require(same == 1.0, f"card and CPU disagree on {1 - same:.6f} of signs")
    return launches


def _radius_cases(gt10: np.ndarray, gt180: np.ndarray, r) -> list:
    """(label, positions, k values, radius) of csrc/radius_knn.cu's checks:
    the main path's two sizes (k 30, radius 0.1), then clouds its grid must
    survive at each list size (K = 8, 16, 32, 64 and k across them): a
    lattice at a spacing of 1/32 (exact ties at every slot), exact
    duplicates, a flat cloud, a line, every point equal, a far outlier, one
    point, fewer points than k, radii that hold only the point or all."""
    small = ellipsoid(3000, SEED + 181)[:, :3]
    g = np.arange(12, dtype=np.float32) / 32
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    dup = small.copy()
    dup[2000:] = dup[:1000]
    flat = small.copy()
    flat[:, 2] = 0.0
    line = np.zeros((3000, 3), np.float32)
    line[:, 0] = r.uniform(-1.0, 1.0, 3000)
    outlier = small.copy()
    outlier[1234] = (1.0e4, 0.0, 0.0)
    ks = (1, 8, 16, 30, 33, 64)
    return [("ellipsoid 180000", gt180[:, :3], (30,), 0.1),
            ("ellipsoid 10000", gt10[:, :3], (30,), 0.1),
            ("ellipsoid 3000", small, ks, 0.1),
            ("lattice ties", lattice[r.permutation(len(lattice))], ks, 0.1),
            ("duplicates", dup, ks, 0.1), ("flat", flat, ks, 0.1),
            ("line", line, ks, 0.1),
            ("all equal", np.full((500, 3), 0.3, np.float32), ks, 0.1),
            ("far outlier", outlier, ks, 0.1),
            ("one point", np.float32([[0.25, -0.5, 0.125]]), (1, 30), 0.1),
            ("fewer points than k", small[:20] * 0.05, (30, 64), 0.1),
            ("radius holds only self", small, (30,), 1e-4),
            ("radius holds every point", small[:2000], (30, 64), 10.0)]


def phase_checks_radius(gt10: np.ndarray, gt180: np.ndarray, dev) -> dict:
    """Normal estimation's search (csrc/radius_knn.cu) bit-equal to its
    plain version (ops/neighbors_cuda.radius_knn_plain) on each case of
    _radius_cases."""
    from dipole_tpu_torch.ops import neighbors_cuda

    err = 0.0
    for label, pos, ks, radius in _radius_cases(gt10, gt180,
                                                np.random.default_rng(SEED + 18)):
        pos = torch.as_tensor(np.ascontiguousarray(pos), device=dev)
        for k in ks:
            err = max(err, _equal("radius_knn", neighbors_cuda.radius_knn(pos, k, radius),
                                  neighbors_cuda.radius_knn_plain(pos, k, radius),
                                  case=label, n=len(pos), k=k, radius=radius))
    return {"radius_knn": err}


def _cdist_topk(pos: torch.Tensor, k: int):
    """The yardstick: torch.cdist and torch.topk in query chunks of 4096."""
    return [torch.topk(torch.cdist(pos[lo:lo + 4096], pos), k, largest=False)
            for lo in range(0, len(pos), 4096)]


def time_radius_knn(gt10: np.ndarray, gt180: np.ndarray, dev) -> dict:
    """csrc/radius_knn.cu at the main path's shapes (a batch call's 180000
    points and a served request's 10000; k 30, radius 0.1): its time by
    events (the bucketing, the sort and the search) and the search kernel's
    by the profiler, its plain version's, the yardstick's, and its bound:
    the positions read once and the lists written once, against N k
    distances."""
    from dipole_tpu_torch.ops import neighbors_cuda as nc

    res = {}
    for label, gt in (("180k", gt180), ("10k", gt10)):
        pos = torch.as_tensor(np.ascontiguousarray(gt[:, :3]), device=dev)
        n, k = len(pos), 30
        b = bound_ms(12 * n + 8 * n * k, OPS_KNN * n * k)
        plain_ms, want = timed(lambda: nc.radius_knn_plain(pos, k, 0.1))
        res[label] = dict(
            shape=f"{n} points, k {k}, radius 0.1",
            max_abs_err=_equal("radius_knn", nc.radius_knn(pos, k, 0.1), want, n=n,
                               k=k, main_path_shape=True),
            ms=cuda_ms(lambda: nc.radius_knn(pos, k, 0.1), 20, 2),
            search_profiler_ms=profiled_ms(lambda: nc.radius_knn(pos, k, 0.1),
                                           "radius_knn_search", 10),
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=cuda_ms(lambda: _cdist_topk(pos, k), 3, 1))
        del want
    emit({"phase": "timing", "kernel": "radius_knn", "results": res, **CARD})
    return {**res["180k"], "other_shapes": {"10k": res["10k"]}}


def phase_timing(gt10: np.ndarray, gt180: np.ndarray, dev) -> dict:
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.utils.io import Transform, gen_grid

    res = {}
    # shapes of the main path: normalized clouds, the 10^3 lattice
    pc180 = torch.as_tensor(Transform.trans(gt180)[0], device=dev)
    pc10 = torch.as_tensor(Transform.trans(scramble(gt10, SEED + 1))[0],
                           device=dev)
    grid = torch.as_tensor(gen_grid(10), device=dev)
    n180, n10 = len(pc180), len(pc10)

    res["dipole_potential"] = _potential_shape(pc180, grid, "180k_3col", 20)

    # each kernel's first call gives the output held against the plain one
    # and warms up its timing
    res["dipole_imatrix"] = _imatrix_shape(pc10, "10k_6col_diffuse", 10)
    I = fields.dipole_interaction_matrix(pc10)
    # the general mode (targets given, no main path) at the same shape
    require(torch.equal(fields.dipole_interaction_matrix(pc10, targets=pc10), I),
            "imatrix: the general mode differs from the symmetric one at 10k")
    res["dipole_imatrix"]["other_shapes"] = {"10k_general": dict(
        shape=f"{n10} x {n10}, targets given",
        ms=cuda_ms(lambda: fields.dipole_interaction_matrix(pc10, targets=pc10), 10, 1),
        profiler_ms=profiled_ms(lambda: fields.dipole_interaction_matrix(
            pc10, targets=pc10), IMATRIX_KERNEL, 10))}
    # both kernels at one patch of the graph_dipole run (24 calls a run)
    patch = _graph_dipole_patch(dev)
    res["dipole_potential"]["other_shapes"] = {"graph_dipole_patch": _potential_shape(
        patch, grid, "graph_dipole10k_grid_cli", 50)}
    res["dipole_imatrix"]["other_shapes"]["graph_dipole_patch"] = _imatrix_shape(
        patch, "graph_dipole10k_grid_cli", 50)

    b = bound_ms(4 * n10 * n10 + 8 * n10, OPS_GREEDY_ROW * n10 * (n10 - 1))
    got = propagate_cuda.greedy_rows(I, 0)
    blocks = propagate_cuda.last_launch()["blocks"]
    plain_ms, want = timed(lambda: propagate.greedy_rows_plain(I, 0))
    res["greedy_rows"] = dict(
        shape=f"{n10} points, row mode", blocks=blocks,
        max_abs_err=_equal("greedy_rows", got, want, n=n10, main_path_shape=True),
        ms=cuda_ms(lambda: propagate_cuda.greedy_rows(I, 0), 3, 0),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])
    del I

    b = bound_ms(24 * n180 + 8 * n180, OPS_GREEDY_COLUMN * n180 * (n180 - 1))
    got = propagate_cuda.greedy_columns(pc180, 0, 1e-6)
    res["greedy_columns"] = dict(
        shape=f"{n180} points, column mode",
        blocks=propagate_cuda.last_launch()["blocks"],
        ms=cuda_ms(lambda: propagate_cuda.greedy_columns(pc180, 0, 1e-6), 2, 0),
        bound_ms=b[0], bound_by=b[1])
    emit({"phase": "timing", "partial": True, "results": res})
    del got

    # the column greedy's time a step against N on its own grid: us a step
    # = a + b N, a fit only (the grid grows with N up to one block an SM)
    sizes = [20000, 50000, 100000, n180]
    per_step = []
    for n in sizes:
        p = pc180[:n].contiguous()
        ms = cuda_ms(lambda: propagate_cuda.greedy_columns(p, 0, 1e-6), 2, 1)
        per_step.append({"n": n, "ms": ms, "us_per_step": 1e3 * ms / (n - 1),
                         **propagate_cuda.last_launch()})
    b_fit, a_fit = np.polyfit([float(x["n"]) for x in per_step],
                              [x["us_per_step"] for x in per_step], 1)
    res["greedy_columns"]["fit_us_per_step"] = {"a_us": float(a_fit),
                                                "b_us_per_point": float(b_fit)}
    # the two costs apart: on the full grid, P = 1, 2, 4, 8 points a thread,
    # us a step = a + b P (a: the exchange and the block's reductions, the
    # design's floor a step on this grid; b: the sweep of a point a thread)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    full_grid = []
    for per in (1, 2, 4, 8):
        n = sms * 1024 * per
        p = torch.as_tensor(Transform.trans(ellipsoid(n, SEED + per))[0], device=dev)
        ms = cuda_ms(lambda: propagate_cuda.greedy_columns(p, 0, 1e-6, _blocks=sms),
                     2 if per <= 2 else 1, 0)
        launch = propagate_cuda.last_launch()
        require(launch == {"blocks": sms, "per_thread": per},
                f"greedy_columns: launch {launch} at {n} points on {sms} blocks")
        full_grid.append({"n": n, "ms": ms, "us_per_step": 1e3 * ms / (n - 1), **launch})
        del p
    b_fit, a_fit = np.polyfit([float(x["per_thread"]) for x in full_grid],
                              [x["us_per_step"] for x in full_grid], 1)
    res["greedy_columns"]["full_grid_us_per_step"] = {
        "blocks": sms, "a_us": float(a_fit), "b_us_per_point_a_thread": float(b_fit)}
    res["greedy_columns"]["step_floor_ms"] = float(a_fit) * (n180 - 1) / 1e3
    # the exchange against the block count: 20480 points, one point a
    # thread or none
    blocks_sweep = []
    p = pc180[:20480].contiguous()
    for g in (20, 40, 80, sms):
        ms = cuda_ms(lambda: propagate_cuda.greedy_columns(p, 0, 1e-6, _blocks=g), 3, 1)
        blocks_sweep.append({"n": 20480, "ms": ms, "us_per_step": 1e3 * ms / 20479,
                             **propagate_cuda.last_launch()})
    # the one-block threshold: one block against a grid of ceil(n / 1024)
    # blocks, row mode (the matrix tier and graph_dipole's patches) and
    # column mode
    threshold = []
    for n in (1024, 2048, 3072, 4096, 4608, 5120, 5632, 6144, 8192):
        p = pc10[:n].contiguous()
        I = fields.dipole_interaction_matrix(p)
        for mode, fn in (("rows", lambda g: propagate_cuda.greedy_rows(I, 0, _blocks=g)),
                         ("columns", lambda g: propagate_cuda.greedy_columns(
                             p, 0, 1e-6, _blocks=g))):
            for blocks in (1, -(-n // 1024) if n > 1024 else 2):
                ms = cuda_ms(lambda: fn(blocks), 3, 1)
                threshold.append({"mode": mode, "n": n, "ms": ms,
                                  "us_per_step": 1e3 * ms / (n - 1),
                                  **propagate_cuda.last_launch()})
        del I
    # the two tiers at MATRIX_LIMIT: matrix + row greedy against columns
    tiers = {"n": n10,
             "matrix_tier_ms": res["dipole_imatrix"]["ms"] + res["greedy_rows"]["ms"],
             "column_tier_ms": cuda_ms(
                 lambda: propagate_cuda.greedy_columns(pc10, 0, 1e-6), 2, 1)}
    emit({"phase": "timing", "results": res, "greedy_columns_per_step": per_step,
          "greedy_columns_full_grid": full_grid,
          "greedy_columns_blocks_at_20480": blocks_sweep,
          "greedy_one_block_threshold": threshold, "tiers_at_matrix_limit": tiers})
    return res


def time_plain_greedy_columns(gt180: np.ndarray, timing: dict, dev) -> None:
    """The plain column greedy at 180k, once (~55 torch ops a step, ~10
    million launches), held bit-equal to the kernel: after every profiled
    timing, since the profiler's traces came back with no device kernel in
    them after it (a probe traced the field after the plain greedy at 20k,
    60k and then 180k in one process on an H100: the third trace was
    empty)."""
    from dipole_tpu_torch.ops import propagate, propagate_cuda
    from dipole_tpu_torch.utils.io import Transform

    pc180 = torch.as_tensor(Transform.trans(gt180)[0], device=dev)
    got = propagate_cuda.greedy_columns(pc180, 0, 1e-6)
    plain_ms, want = timed(lambda: propagate.greedy_columns_plain(pc180, 0, 1e-6))
    timing["greedy_columns"]["plain_ms"] = plain_ms
    timing["greedy_columns"]["max_abs_err"] = _equal(
        "greedy_columns", got, want, n=len(pc180), main_path_shape=True)


def _potential_shape(src, grid, run, reps) -> dict:
    """The potential at the lattice from sources src: held to its plain
    version per target, timed by events and by the profiler's kernel time,
    with its bound and its launches per call of main-path run `run`."""
    from dipole_tpu_torch.ops import fields

    S, T = len(src), len(grid)
    got = fields.potential(src, grid)
    plain_ms, want = timed(lambda: fields.potential_plain(src, grid))
    b = bound_ms(24 * S + 12 * T + 4 * T, OPS_POTENTIAL * T * S)
    return dict(
        shape=f"{T} targets x {S} sources",
        max_abs_err=float((got - want).abs().max()),
        max_err_over_tol=_potential_err(got, want),
        ms=cuda_ms(lambda: fields.potential(src, grid), reps, 3),
        profiler_ms=profiled_ms(lambda: fields.potential(src, grid),
                                ("potential_partial", "potential_finish"), reps),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        launches_per_call=RUN_COUNTS[run]["dipole_potential"])


def _imatrix_shape(pts, run, reps) -> dict:
    """The dipole matrix of pts (targets = sources): held bit-equal to its
    plain version, timed by events and by the profiler's kernel time, with
    its bound and its launches per call of main-path run `run`."""
    from dipole_tpu_torch.ops import fields

    n = len(pts)
    got = fields.dipole_interaction_matrix(pts)
    plain_ms, want = timed(lambda: fields.dipole_interaction_matrix_plain(pts, pts, 1e-6))
    err = _equal("dipole_imatrix", got, want, n=n, main_path_shape=run)
    del got, want
    b = bound_ms(24 * 2 * n + 4 * n * n, OPS_IMATRIX * n * n)
    return dict(
        shape=f"{n} x {n}", max_abs_err=err,
        ms=cuda_ms(lambda: fields.dipole_interaction_matrix(pts), reps, 1),
        profiler_ms=profiled_ms(lambda: fields.dipole_interaction_matrix(pts),
                                IMATRIX_KERNEL, reps),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        launches_per_call=RUN_COUNTS[run]["dipole_imatrix"])


def _graph_dipole_patch(dev) -> torch.Tensor:
    """One patch of graph_dipole's run on the 10k ellipsoid (grid, 10
    parts: 24 patches of 151-624 points), the one nearest the mean size,
    normalized as propagate_points_file does before its matrix and its
    sign fix."""
    from dipole_tpu_torch.ops.patching import divide_pc_with_ijk
    from dipole_tpu_torch.utils.io import Transform

    pc = Transform.trans(ellipsoid(10000, SEED))[0]
    patches, _ = divide_pc_with_ijk(pc, 10, (-1.5, 1.5), 0)
    mean = len(pc) / len(patches)
    patch = min(patches, key=lambda p: abs(len(p) - mean))
    return torch.as_tensor(Transform.trans(pc[patch])[0], device=dev)


def _patch_run(label, fn, gt, path_kernels, launches):
    """One main-path run that returns a cloud: _kernel_run, then the output's
    shape, positions and GT sign agreement."""
    from dipole_tpu_torch.ops.metrics import sign_agreement

    out = _kernel_run(label, fn, path_kernels, launches,
                      lambda out: {"n": len(out), "gt_sign_agreement":
                                   sign_agreement(out, gt)})
    require(out.shape == (len(gt), 6) and bool(np.isfinite(out).all()),
            f"{label}: bad output")
    require(np.allclose(out[:, :3], gt[:, :3], atol=1e-4), f"{label}: positions moved")
    return out, sign_agreement(out, gt)


def _kernel_run(label, fn, path_kernels, launches, report=None):
    """One main-path run: launch counts reset just before fn(timer) and read
    just after, stage seconds, report(output) merged into the line; each
    path kernel launched, no plain version called on a CUDA tensor."""
    from dipole_tpu_torch.utils.timing import timer_factory

    timer = timer_factory()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn(timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = _read_counts()
    RUN_COUNTS[label] = counts
    emit({"phase": "main_path", "run": label, "seconds": wall, "stages": timer.stages,
          **(report(out) if report else {}),
          "launches": counts, "plain_cuda_calls": plain})
    for name in path_kernels:
        require(counts[name] > 0, f"{label}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{label}: plain version called on CUDA: {plain}")
    return out


HAND_FLAGS = dict(iters=10, propagation_iters=5, number_parts=30,
                  minimum_points_per_patch=100, curvature_threshold=0.01,
                  diffuse=True, weighted_prop=True, estimate=True)
LION_FLAGS = dict(iters=5, number_parts=41, minimum_points_per_patch=100, n=50)


def phase_main_path_patches(hand10, hand180, lion, launches) -> np.ndarray:
    """The patch pipelines with the v1 trio: orient_patches (hand demo),
    orient_large (lion demo), transfer_orientation (hand 10k -> 180k)."""
    from dipole_tpu_torch import api
    from dipole_tpu_torch.ops.metrics import sign_agreement

    models = [str(m) for m in MODELS]
    hand_out, a_hand = _patch_run(
        "hand10k_orient_patches",
        lambda timer: api.orient_patches(hand10[:, :3].copy(), models=models,
                                         timer=timer, device="cuda", **HAND_FLAGS),
        hand10, ("dipole_group", "knn", "fps", "dipole_potential"), launches)
    _, a_lion = _patch_run(
        "lion180k_orient_large",
        lambda timer: api.orient_large(scramble(lion, SEED + 5), models=models,
                                       timer=timer, device="cuda", **LION_FLAGS),
        lion, ("dipole_group", "dipole_field", "knn", "fps", "dipole_potential"),
        launches)
    _, a_tr = _patch_run(
        "hand_transfer_10k_to_180k",
        lambda timer: api.transfer_orientation(hand_out, scramble(hand180, SEED + 6),
                                               device="cuda"),
        hand180, ("dipole_field",), launches)
    require(a_hand >= 0.9 and a_lion >= 0.95 and a_tr >= 0.95,
            f"GT sign agreement too low: hand {a_hand}, lion {a_lion}, "
            f"transfer {a_tr}")

    # the card against the CPU path on a small input (one model, 2 rounds)
    small = hand10[::5, :3].copy()
    kw = dict(models=models[:1], iters=2, propagation_iters=1, number_parts=12,
              minimum_points_per_patch=50, diffuse=True, weighted_prop=True,
              estimate=True)
    on_card = api.orient_patches(small, device="cuda", **kw)
    on_cpu = api.orient_patches(small, device="cpu", **kw)
    same = float(((on_card[:, 3:6] * on_cpu[:, 3:6]).sum(1) > 0).mean())
    emit({"phase": "main_path", "run": "2k_patches_card_vs_cpu", "same_sign": same,
          "gt_card": sign_agreement(on_card, hand10[::5]),
          "gt_cpu": sign_agreement(on_cpu, hand10[::5])})
    require(same >= 0.95, f"orient_patches: card and CPU disagree on "
                          f"{1 - same:.4f} of signs")
    return hand_out


def phase_timing_patches(hand_out, hand180, lion, dev) -> dict:
    """The patch kernels at the main path's largest calls."""
    from dipole_tpu_torch.api import MAX_PATCH_SIZE
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.ops import fields, neighbors
    from dipole_tpu_torch.ops.patching import divide_pc
    from dipole_tpu_torch.utils import prng
    from dipole_tpu_torch.utils.io import Transform

    res = {}
    # field: the transfer, 10000 oriented sources at 180000 targets
    res["dipole_field"] = _field_shape(
        "transfer", torch.as_tensor(hand_out, device=dev),
        torch.as_tensor(hand180[:, :3].copy(), device=dev),
        "hand_transfer_10k_to_180k", 10)

    # the lion's patches and representatives (orient_large's picks)
    pc = Transform.trans(lion)[0]
    patches = divide_pc(pc[:, :3], LION_FLAGS["number_parts"],
                        min_patch=LION_FLAGS["minimum_points_per_patch"])
    rng = np.random.default_rng(1)
    perms = [p[rng.permutation(len(p))] for p in patches]
    reps = [p[:MAX_PATCH_SIZE] for p in perms]
    rest = np.concatenate([p[MAX_PATCH_SIZE:] for p in perms])
    # field: orient_large's rest-point re-vote, the representatives as
    # sources at every other point (ops/propagate.py:300-308)
    res["dipole_field"]["other_shapes"] = {
        "lion_rest_revote": _field_shape(
            "lion_rest_revote", torch.as_tensor(pc[np.concatenate(reps)], device=dev),
            torch.as_tensor(pc[rest, :3], device=dev), "lion180k_orient_large", 5),
        "graph_dipole_edge": _field_edge_shape(dev)}

    # group: the lion's representatives
    pts = torch.as_tensor(pc[np.concatenate(reps)], device=dev)
    gid = torch.as_tensor(np.concatenate([np.full(len(r), i) for i, r in enumerate(reps)]),
                          device=dev)
    N, G = len(pts), len(reps)
    got = fields.point_group_interaction(pts, gid, G)
    plain_ms, want = timed(lambda: fields.point_group_interaction_plain(pts, gid, G, 1e-5))
    scale = _group_scale(pts, gid, G)
    b = bound_ms(24 * N * 2 + 8 * N + 4 * N * G, OPS_GROUP * N * N)
    res["dipole_group"] = dict(
        shape=f"{N} points x {G} groups",
        max_abs_err=_per_entry("dipole_group", got, want, scale,
                               1e-4, main_path_shape=True, points=N, groups=G),
        ms=cuda_ms(lambda: fields.point_group_interaction(pts, gid, G), 3, 0),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        launches_per_lion_call=RUN_COUNTS["lion180k_orient_large"]["dipole_group"])
    del got, want, scale
    res["dipole_group"]["hand_shape"] = _group_hand_shape(hand_out, dev)

    # knn and fps: the first forward chunk of the lion's ensemble
    patches = [pc[r] for r in reps]
    nb = pointcnn._bucket(max(len(p) for p in patches))
    pool = 0.6
    m1, _ = pointcnn._pad_sizes(nb, pool)
    batch, valid, _, lens = pointcnn.prepare_patch_batches(
        patches, nb, pointcnn._forward_width(nb, pool), dev)[0]
    _, pos1 = pointcnn._canonicalize(batch, valid)
    st = np.zeros(len(batch), np.int32)
    st[:len(lens)] = pointcnn.key_starts(prng.prng_key(1), lens, pool, m1)[:, 0]
    starts = torch.as_tensor(st, device=dev)
    B, k = len(batch), 20
    got = neighbors.knn_with_dist(pos1, pos1, k)
    plain_ms, want = timed(lambda: neighbors.knn_with_dist_plain(pos1, pos1, k))
    d2 = neighbors._sq_dist(pos1[:, :, None, :], pos1[:, None, :, :])
    b = bound_ms(12 * B * nb * 2 + 8 * B * nb * k, OPS_KNN * B * nb * nb)
    res["knn"] = dict(
        shape=f"{B} x {nb} x {nb}, k={k}",
        max_abs_err=_equal("knn", got, want, main_path_shape=True, shape=[B, nb, nb]),
        ms=cuda_ms(lambda: neighbors.knn_with_dist(pos1, pos1, k), 20, 1),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        library_ms=cuda_ms(lambda: torch.topk(d2, k, dim=-1, largest=False), 20, 1))
    del d2
    res["knn"]["forward_shapes"], fps2 = _knn_forward_shapes(
        pos1, valid, nb, pool, m1, lens, dev)
    res["knn"]["ms_per_forward"] = sum(x["ms"] for x in res["knn"]["forward_shapes"])
    got = neighbors.fps_masked_batch(pos1, valid, m1, starts)
    plain_ms, want = timed(lambda: neighbors.fps_masked_batch_plain(pos1, valid, m1, starts))
    b = bound_ms(12 * B * nb + B * nb + 4 * B + 4 * B * m1,
                 OPS_FPS * B * (m1 - 1) * nb)
    res["fps"] = dict(
        shape=f"{B} x {nb}, m={m1}",
        max_abs_err=_equal("fps", got, want, main_path_shape=True, shape=[B, nb]),
        ms=cuda_ms(lambda: neighbors.fps_masked_batch(pos1, valid, m1, starts), 20, 1),
        profiler_ms=profiled_ms(lambda: neighbors.fps_masked_batch(pos1, valid, m1, starts),
                                "fps_kernel", 20),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], second_launch=fps2)
    emit({"phase": "timing", "patch_kernels": res})
    _profile_forward(batch, valid, pointcnn.key_starts(prng.prng_key(1), lens, pool, m1),
                     dev)
    return res


def _field_shape(label, src, tgt, run, reps) -> dict:
    """The field kernel at one main-path shape: held to its plain version,
    timed by events and by the profiler's kernel time, with its bound and
    its launches per call of main-path run `run`."""
    from dipole_tpu_torch.ops import fields

    S, T = len(src), len(tgt)
    got = fields.field_grad(src, tgt)
    plain_ms, want = timed(lambda: fields.field_grad_plain(src, tgt, 1e-5))
    b = bound_ms(24 * S + 12 * T + 12 * T, OPS_FIELD * S * T)
    return dict(
        shape=f"{S} sources x {T} targets",
        max_abs_err=_per_entry("dipole_field", got, want, _field_scale(want), 1e-4,
                               main_path_shape=label, sources=S, targets=T),
        ms=cuda_ms(lambda: fields.field_grad(src, tgt), reps, 1),
        profiler_ms=profiled_ms(lambda: fields.field_grad(src, tgt),
                                ("field_partial", "field_finish"), reps),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        launches_per_call=RUN_COUNTS[run]["dipole_field"])


def _field_edge_shape(dev) -> dict:
    """The field at one edge of graph_dipole's run on the 10k ellipsoid
    (grid, 10 parts): the first pair of grid-adjacent patches, as
    pipelines/graph_dipole.divide_pc_to_graph takes them."""
    from dipole_tpu_torch.ops.patching import divide_pc_with_ijk
    from dipole_tpu_torch.utils.io import Transform

    pc = Transform.trans(ellipsoid(10000, SEED))[0]
    patches, ijk = divide_pc_with_ijk(pc, 10, (-1.5, 1.5), 0)
    i, j = next((i, j) for i in range(len(patches)) for j in range(i + 1, len(patches))
                if any(np.abs(a - b).sum() == 1 for a in ijk[i] for b in ijk[j]))
    return _field_shape("graph_dipole_edge", torch.as_tensor(pc[patches[i]], device=dev),
                        torch.as_tensor(pc[patches[j], :3], device=dev),
                        "graph_dipole10k_grid_cli", 50)


def _group_hand_shape(hand_out, dev) -> dict:
    """The group kernel at the hand run's shape: its 10000 points in the
    patches of the hand demo's flags (all_patches of api.orient_patches),
    held to the plain version, timed, with its launches per call."""
    from dipole_tpu_torch.ops import fields
    from dipole_tpu_torch.ops.patching import divide_pc
    from dipole_tpu_torch.utils.io import Transform

    pc = Transform.trans(hand_out)[0]
    patches = divide_pc(pc[:, :3], HAND_FLAGS["number_parts"],
                        min_patch=HAND_FLAGS["minimum_points_per_patch"])
    seg = np.zeros(len(pc), np.int64)
    for i, p in enumerate(patches):
        seg[np.asarray(p)] = i
    pts = torch.as_tensor(pc, device=dev)
    gid = torch.as_tensor(seg, device=dev)
    N, G = len(pts), len(patches)
    got = fields.point_group_interaction(pts, gid, G)
    plain_ms, want = timed(lambda: fields.point_group_interaction_plain(pts, gid, G, 1e-5))
    b = bound_ms(24 * N * 2 + 8 * N + 4 * N * G, OPS_GROUP * N * N)
    return dict(
        shape=f"{N} points x {G} groups",
        max_abs_err=_per_entry("dipole_group", got, want, _group_scale(pts, gid, G),
                               1e-4, main_path_shape=True, points=N, groups=G),
        ms=cuda_ms(lambda: fields.point_group_interaction(pts, gid, G), 20, 1),
        profiler_ms=profiled_ms(lambda: fields.point_group_interaction(pts, gid, G),
                                "group_kernel", 20),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        launches_per_hand_call=RUN_COUNTS["hand10k_orient_patches"]["dipole_group"])


def _knn_forward_shapes(pos1, valid, nb, pool, m1, lens, dev):
    """kNN at each of the forward's five calls (PointCNN.forward_sels): the
    k = 20 self searches on the rows of the three pooling stages and the
    k = 16 interpolations between them, on the lion's first chunk; each
    bit-equal to the plain search, its time by CUDA events and by the
    profiler's kernel time, its bound, the plain version's and torch.topk's
    time, and its launches per lion call (the lion run's kNN launches over
    the five calls a forward). Also the forward's second FPS (m2 of the m1
    rows of pos2): (shapes, fps2)."""
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.ops import neighbors
    from dipole_tpu_torch.utils import prng

    B = len(pos1)
    st = np.zeros((B, 2), np.int32)
    st[:len(lens)] = pointcnn.key_starts(prng.prng_key(1), lens, pool, m1)
    st = torch.as_tensor(st, device=dev)
    m2 = pointcnn._pad_sizes(nb, pool)[1]
    _, valid2, pos2, sel2 = pointcnn.PointCNN(pool).fps_selections(
        pos1, valid, m1, m2, st[:, 0], st[:, 1])
    valid3 = pointcnn._pool_valid(valid2, pool, m2)
    pos3 = torch.where(valid3[..., None], pointcnn._gather(pos2, sel2),
                       torch.full((1, 1, 1), pointcnn._SENTINEL, device=dev))
    per_call = RUN_COUNTS["lion180k_orient_large"]["knn"] / 5
    out = []
    for what, dst, src, k in (("self", pos1, pos1, 20), ("self", pos2, pos2, 20),
                              ("self", pos3, pos3, 20), ("interpolate", pos2, pos3, 16),
                              ("interpolate", pos1, pos2, 16)):
        nd, ns = dst.shape[1], src.shape[1]
        plain_ms, want = timed(lambda: neighbors.knn_with_dist_plain(dst, src, k))
        err = _equal("knn", neighbors.knn_with_dist(dst, src, k), want,
                     main_path_shape=True, shape=[B, nd, ns], k=k)
        d2 = neighbors._sq_dist(dst[:, :, None, :], src[:, None, :, :])
        b = bound_ms(12 * B * (nd + ns) + 8 * B * nd * k, OPS_KNN * B * nd * ns)
        # by CUDA events and by the profiler's kernel time: the wrapper's
        # host cost shows in the first at these sizes
        out.append(dict(call=f"{what} {nd} <- {ns}, k={k}", shape=[B, nd, ns],
                        ms=cuda_ms(lambda: neighbors.knn_with_dist(dst, src, k), 20, 1),
                        profiler_ms=profiled_ms(
                            lambda: neighbors.knn_with_dist(dst, src, k), "knn_kernel", 20),
                        plain_ms=plain_ms,
                        library_ms=cuda_ms(lambda: torch.topk(d2, k, dim=-1, largest=False),
                                           20, 1),
                        launches_per_lion_call=per_call, bound_ms=b[0],
                        bound_by=b[1], max_abs_err=err))
        del d2, want
    # the second FPS: the m1 rows of pos2, m2 picks
    s2 = st[:, 1]
    plain_ms, want = timed(lambda: neighbors.fps_masked_batch_plain(pos2, valid2, m2, s2))
    err = _equal("fps", neighbors.fps_masked_batch(pos2, valid2, m2, s2), want,
                 main_path_shape=True, shape=[B, m1])
    b = bound_ms(12 * B * m1 + B * m1 + 4 * B + 4 * B * m2, OPS_FPS * B * (m2 - 1) * m1)
    fps2 = dict(shape=f"{B} x {m1}, m={m2}", max_abs_err=err, plain_ms=plain_ms,
                ms=cuda_ms(lambda: neighbors.fps_masked_batch(pos2, valid2, m2, s2), 20, 1),
                profiler_ms=profiled_ms(lambda: neighbors.fps_masked_batch(pos2, valid2, m2, s2),
                                        "fps_kernel", 20),
                bound_ms=b[0], bound_by=b[1],
                launches_per_lion_call=RUN_COUNTS["lion180k_orient_large"]["fps"] / 2)
    return out, fps2


def profiled_ms(fn, name, reps: int) -> float:
    """Mean device time of the kernels whose name holds `name` (or, for a
    tuple of names, the sum of each name's mean), by torch.profiler over
    reps calls of fn (after one warm-up call). A trace that lost the
    kernels' records (seen once in a few hundred) is taken again after a
    pause, up to six times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = []
        for part in (name,) if isinstance(name, str) else name:
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and part in e.key]
            calls = sum(e.count for e in events)
            if calls:
                ms.append(sum(e.self_device_time_total for e in events) / 1e3 / calls)
        if ms:
            return sum(ms)
    seen = sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})[:8]
    raise CheckFailed(f"profiler: no device kernel named {name} (the last "
                      f"trace's device kernels: {seen})")


def _profile_forward(batch, valid, starts, dev) -> None:
    """One PointCNN forward over the chunk, by CUDA events and under
    torch.profiler: its time, the device's busy share and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipole_tpu_torch.models import pointcnn

    model = pointcnn.PointCNN.from_files(MODELS[0]).to(dev)
    st = np.zeros((len(batch), 2), np.int32)
    st[:len(starts)] = starts
    st = torch.as_tensor(st, device=dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: model(batch, valid, st[:, 0], st[:, 1]), 5, 2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch, valid, st[:, 0], st[:, 1])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies), not the CPU ops that launched
    # them, which report the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    emit({"phase": "profile", "what": "one PointCNN forward",
          "shape": list(batch.shape), "ms": ms, "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
          "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                           "calls": e.count} for e in top]})


def _rel_inter(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """max |got - want| / (sum |I w| of the entry), the replay's recorded
    interactions against its plain version's."""
    return float(((got - want).abs() / scale.clamp_min(1e-300)).max()) if got.numel() else 0.0


def _replay_scale(I, orders, knn_idx, colw, w) -> torch.Tensor:
    """sum over the row's kept entries of |I colw w| for each recorded
    interaction: the scale of the replay's tolerance."""
    T, n = orders.shape[0], I.shape[0]
    scale = torch.zeros((T, n), dtype=torch.float64, device=I.device)
    for t in range(T):
        for b in range(0, orders.shape[1], 2048):
            idx = orders[t, b:b + 2048]
            rows = I[idx]
            if knn_idx is not None:
                rows = rows * (knn_idx[None, :, :] == idx[:, None, None]).any(-1)
            if colw is not None:
                rows = rows * colw[None, :]
            scale[t, idx] = (rows.double() * w[t].double()).abs().sum(1)
    return scale


def check_replay(name_info: dict, I, orders, knn_idx, colw) -> float:
    """The replay kernel against its plain version: identical decisions and
    flips, the recorded interactions within 1e-6 of sum |I w|."""
    from dipole_tpu_torch.ops import propagate, propagate_cuda

    w_k, i_k = propagate_cuda.replay(I, orders, knn_idx, colw)
    w_p, i_p = propagate.replay_plain(I, orders, knn_idx, colw)
    torch.cuda.synchronize()
    flips_same = bool(torch.equal(i_k < 0, i_p < 0))
    rel = _rel_inter(i_k, i_p, _replay_scale(I, orders, knn_idx, colw, w_p))
    err = float((i_k - i_p).abs().max())
    emit({"phase": "check", "kernel": "replay", **name_info,
          "blocks": propagate_cuda.last_launch()["blocks"], "w_equal": bool(torch.equal(w_k, w_p)),
          "flips_identical": flips_same, "max_abs_err": err,
          "max_err_over_sum_abs": rel})
    require(torch.equal(w_k, w_p) and flips_same,
            f"replay: decisions differ ({name_info})")
    require(rel <= 1e-6, f"replay: inter off by {rel} of sum |I w| ({name_info})")
    return err


def phase_checks_xie(gt10: np.ndarray, dev) -> dict:
    """The xie slice's kernels against their plain versions: the xie matrix
    in both layouts (bit-equal), the xie greedy (acc and sign bit-equal)
    and the in-order replay (identical flips)."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.utils.io import Transform

    errs = {"xie_imatrix": 0.0, "greedy_xie": 0.0, "replay": 0.0}
    r = np.random.default_rng(SEED + 30)
    # the replay's cloud and column weights
    n = 1500
    pc = Transform.trans(scramble(gt10[:n], SEED + 33))[0]
    colw = torch.as_tensor(r.uniform(0.2, 1.0, n).astype(np.float32), device=dev)
    # first the whole paths with their diffuse re-votes, card against CPU
    # (host-heavy: done before the kernel checks, which leave the card warm
    # for the main path)
    orders = np.stack([r.permutation(n) for _ in range(3)])
    for kernel in ("xie", "dipole"):
        for masked in (False, True):
            kw = dict(diffuse=True, kernel=kernel, knn_mask=8 if masked else -1,
                      points_weight=colw.cpu().numpy())
            on_card = propagate.xie_propagation_in_order(pc, orders, device="cuda", **kw)
            on_cpu = propagate.xie_propagation_in_order(pc, orders, device="cpu", **kw)
            same = float((on_card == on_cpu).mean())
            emit({"phase": "check", "kernel": "replay", "what": "diffuse, card vs CPU",
                  "kernel_matrix": kernel, "knn_mask": masked, "same_flips": same})
            # the dense re-vote is a float32 matmul, summed in another order
            # on each device: a near-zero interaction may take another sign
            require(same >= 0.999, f"replay diffuse ({kernel}, mask {masked}): "
                                   f"card and CPU differ on {1 - same:.6f} of flips")
    # the sequential xie, diffuse and masked, card against CPU
    for kk in (-1, 8):
        on_card = propagate.xie_propagation_points(pc, diffuse=True, knn_mask=kk,
                                                   device="cuda")
        on_cpu = propagate.xie_propagation_points(pc, diffuse=True, knn_mask=kk,
                                                  device="cpu")
        same = float(((on_card[:, 3:6] * on_cpu[:, 3:6]).sum(1) > 0).mean())
        emit({"phase": "check", "kernel": "greedy_xie", "what": "diffuse, card vs CPU",
              "knn_mask": kk, "same_sign": same})
        require(same >= 0.999, f"xie diffuse (mask {kk}): card and CPU differ on "
                               f"{1 - same:.6f} of signs")
    # xie matrix: 4096 points (coincident pairs and a pair 1e-20 apart whose
    # entry overflows to non-finite), a non-multiple size, C != 3, targets
    # other than the sources
    pts = torch.as_tensor(Transform.trans(gt10[:4096])[0], device=dev)
    pts[3840:] = pts[:256]
    pts[1000, :3] = 0.0
    pts[1001, :3] = torch.tensor([1e-20, 0.0, 0.0])
    tgt = torch.as_tensor(ellipsoid(777, SEED + 31), device=dev) * 1.3
    cases = [("4096", pts, None, 3.0), ("3001", pts[:3001].contiguous(), None, 3.0),
             ("129", pts[:129].contiguous(), None, 3.0),
             ("C=2.5", pts[:2500].contiguous(), None, 2.5),
             ("targets", pts[:3001].contiguous(), tgt, 3.0)]
    for label, src, targets, C in cases:
        t_ = src if targets is None else targets
        k = fields.xie_interaction_matrix(src, C=C, targets=targets)
        kt = fields.xie_interaction_matrix(src, C=C, targets=targets, transposed=True)
        p = fields.xie_interaction_matrix_plain(t_, src, C)
        pt = fields.xie_interaction_matrix_plain(t_, src, C, transposed=True)
        torch.cuda.synchronize()
        errs["xie_imatrix"] = max(errs["xie_imatrix"], _equal(
            "xie_imatrix", (k, kt), (p, pt), case=label, shape=list(k.shape)))
        require(torch.equal(kt, k.t()), f"xie_imatrix: layouts differ ({label})")
        if label == "4096":
            a = pts[:256]
            nn = a[:, 3] * a[:, 3] + a[:, 4] * a[:, 4] + a[:, 5] * a[:, 5]
            require(torch.equal(k[torch.arange(3840, 4096), torch.arange(256)], nn),
                    "xie_imatrix: coincident entries are not n.n")
            require(float(k[1000, 1001]) == 0.0 and float(k[1001, 1000]) == 0.0,
                    "xie_imatrix: non-finite pair not 0")

    # xie greedy: 2000, 10000 and 30000 points from a nonzero start, and its
    # launch shapes and ties (_xie_greedy_cases); each with and without the
    # kNN mask
    for label, pcg, start, kw, ties in _xie_greedy_cases(gt10, dev):
        IT = fields.xie_interaction_matrix(torch.as_tensor(pcg, device=dev),
                                           transposed=True)
        if label == "many zero entries":
            # most entries 0, some -0: many acc values tie at 0
            z = torch.as_tensor(r.random(IT.shape) < 0.9, device=dev)
            IT[z] = 0.0
            IT[torch.as_tensor(r.random(IT.shape) < 0.05, device=dev)] = -0.0
        for kk in (0, 8):
            knn = (None if kk == 0 else
                   torch.as_tensor(propagate._knn_idx(pcg, kk), device=dev))
            t0 = time.perf_counter()
            got = propagate_cuda.xie_greedy(IT, start, knn, **kw)
            launch = propagate_cuda.last_launch()
            want = propagate.xie_greedy_plain(IT, start, knn)
            torch.cuda.synchronize()
            n_ = len(pcg)
            errs["greedy_xie"] = max(errs["greedy_xie"], _equal(
                "greedy_xie", got, want, case=label, n=n_, start=start, knn_mask=kk,
                launch=launch, seconds=time.perf_counter() - t0))
            require(bool((got[1].abs() == 1).all()), "greedy_xie: a sign is not +-1")
            if ties and not kk:   # (the mask may keep one twin, not the other)
                h = n_ // 2
                require(torch.equal(got[0][:h], got[0][h:2 * h]),
                        f"greedy_xie: the duplicated points' acc differ ({label})")
        del IT

    # replay: T in {1, 3, 9}, xie and dipole, kNN mask and points_weight
    pct = torch.as_tensor(pc, device=dev)
    knn = torch.as_tensor(propagate._knn_idx(pc, 8), device=dev)
    mats = {"xie": fields.xie_interaction_matrix(pct),
            "dipole": fields.dipole_interaction_matrix(pct)}
    # 1500 and 700 steps: the 128-step block divides neither
    for T in (1, 3, 9):
        orders = torch.as_tensor(np.stack([r.permutation(n) for _ in range(T)]),
                                 device=dev)
        for kernel, I in mats.items():
            for masked, steps in ((False, 1500), (False, 700), (True, 1500)):
                for weighted in (False, True):
                    errs["replay"] = max(errs["replay"], check_replay(
                        dict(n=n, T=T, steps=steps, matrix=kernel, knn_mask=masked,
                             points_weight=weighted),
                        I, orders[:, :steps].contiguous(), knn if masked else None,
                        colw if weighted else None))
    # orders that visit indices again (inside a block of steps and across
    # blocks; a later visit overwrites), orders shorter than N, orders over
    # seven indices
    reps = r.integers(0, n, (3, 2000))
    reps[:, 1200:1300] = reps[:, 40:140]
    reps[:, 60:70] = reps[:, 50:60]
    kinds = {"repeats": reps,
             "short": np.stack([r.permutation(n)[:777] for _ in range(3)]),
             "seven_indices": r.integers(0, 7, (3, 500))}
    for kind, o in kinds.items():
        orders = torch.as_tensor(o, device=dev)
        for kernel, I in mats.items():
            for masked in (False, True):
                errs["replay"] = max(errs["replay"], check_replay(
                    dict(n=n, T=3, steps=o.shape[1], orders=kind, matrix=kernel,
                         knn_mask=masked, points_weight=True),
                    I, orders, knn if masked else None, colw))
    errs["replay_batched"] = check_replay_batched(gt10, dev)
    return errs


def _replay_lane_vs_plain(what, I, o, w, inter, wp, ip) -> float:
    """A batched replay's lane (one cloud's orders) against the plain
    version's: w equal, flips identical, inter within 1e-6 of sum |I w|.
    Returns that relative error."""
    rel = _rel_inter(inter, ip, _replay_scale(I, o, None, None, wp))
    require(torch.equal(w, wp) and torch.equal(inter < 0, ip < 0) and rel <= 1e-6,
            f"replay_batched: lane off its plain version ({what}; off by {rel} of "
            "sum |I w|)")
    return rel


def check_replay_batched(gt10: np.ndarray, dev) -> float:
    """The batched replay, each lane against the replay of its cloud alone
    (w and inter bit-equal) and against the plain version (w equal, flips
    identical, inter within 1e-6 of sum |I w|): B = 1, 2, 3 and 8 clouds of
    unequal sizes with orders of unequal lengths (one set over repeated
    indices, one of 2 orders, one empty), xie and dipole matrices; and 20
    clouds of 3 orders, 60 lanes, more than one blocked loop takes."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.utils.io import Transform

    r = np.random.default_rng(SEED + 40)
    err = 0.0
    cases = {"B=1": [(1500, 3, 1500)], "B=2": [(1500, 3, 1500), (700, 3, 333)],
             "B=3": [(1200, 3, 2400), (700, 2, 700), (129, 3, 0)],
             "B=8": [(600 + 100 * b, 3, 600 + 70 * b) for b in range(8)],
             "60 lanes": [(300, 3, 300)] * 20}
    for label, spec in cases.items():
        for kernel in ("xie", "dipole") if label != "60 lanes" else ("xie",):
            mats, orders = [], []
            for b, (n, T, steps) in enumerate(spec):
                at = (b * 700) % (len(gt10) - n)
                pc = torch.as_tensor(Transform.trans(scramble(gt10[at:at + n],
                                                              SEED + 41 + b))[0], device=dev)
                mats.append(fields.xie_interaction_matrix(pc) if kernel == "xie"
                            else fields.dipole_interaction_matrix(pc))
                o = np.stack([np.concatenate([r.permutation(n), r.permutation(n)])[:steps]
                              for _ in range(T)]).reshape(T, steps)
                if label == "B=3" and b == 0:
                    o[:, 1500:1600] = o[:, 40:140]          # visits again
                orders.append(torch.as_tensor(o, device=dev))
            got = propagate_cuda.replay_batched(mats, orders)
            lanes = []
            for I, o, (w, inter) in zip(mats, orders, got):
                w1, i1 = propagate_cuda.replay(I, o)
                wp, ip = propagate.replay_plain(I, o)
                torch.cuda.synchronize()
                same = torch.equal(w, w1) and torch.equal(inter, i1)
                require(same, f"replay_batched: lane differs from its single replay "
                              f"({label}, {kernel})")
                rel = _replay_lane_vs_plain(f"{label}, {kernel}", I, o, w, inter, wp, ip)
                lanes.append({"n": I.shape[0], "T": o.shape[0], "steps": o.shape[1],
                              "bit_equal_single": same, "decisions_equal_plain": True,
                              "max_err_over_sum_abs": rel})
                err = max(err, float((inter - ip).abs().max()) if inter.numel() else 0.0)
            emit({"phase": "check", "kernel": "replay_batched", "case": label,
                  "matrix": kernel, "lanes": lanes})
            del mats
    return err


def _xie_greedy_cases(gt10: np.ndarray, dev) -> list:
    """(label, cloud, start, wrapper kwargs, ties) of the xie greedy checks:
    2000, 10000 and 30000 points (the server's cap); a cloud whose second
    half duplicates its first, on one block and across 6 (exact ties in
    acc, each pair in two blocks); both sides of the one-block limit; one
    block of 8 points a thread; a matrix with most entries 0."""
    from dipole_tpu_torch.ops import propagate_cuda
    from dipole_tpu_torch.utils.io import Transform

    def cloud(n, seed, ties=False):
        base = gt10 if n <= len(gt10) else ellipsoid(n, SEED + 30)
        pc = Transform.trans(scramble(base[:n], seed))[0]
        if ties:
            pc[n // 2:] = pc[:n // 2]
        return pc

    thr = propagate_cuda.one_block_max_n("xie")
    return [
        ("2000", cloud(2000, SEED + 2000), 17, {}, False),
        ("10000", cloud(10000, SEED + 10000), 5, {}, False),
        ("30000", cloud(30000, SEED + 30000), 29, {}, False),
        ("ties, one block", cloud(3000, SEED + 3001, True), 3, {}, True),
        ("ties across 6 blocks", cloud(6000, SEED + 6000, True), 3, {"_blocks": 6}, True),
        ("one-block limit", cloud(thr, SEED + thr), 7, {}, False),
        ("one-block limit + 1", cloud(thr + 1, SEED + thr + 1), 7, {}, False),
        ("one block, 8 points a thread", cloud(8192, SEED + 8192), 7,
         {"_blocks": 1}, False),
        ("many zero entries", cloud(4000, SEED + 4000), 11, {"_blocks": 4}, False),
    ]


XIE_RUNS = (("xie10k", 10000, "xie", {}),
            ("tree_xie30k_times3", 30000, "tree_xie", {"times": 3}),
            ("hoppe30k", 30000, "hoppe", {}))
XIE_PATH_KERNELS = {"xie": ("xie_imatrix", "greedy_xie", "dipole_potential"),
                    "tree_xie": ("xie_imatrix", "replay", "dipole_potential"),
                    "hoppe": ()}


def phase_main_path_xie(gt10, gt30, launches) -> dict:
    """api.orient's xie methods on the scrambled ellipsoids (xyz only: the
    normals are re-estimated, as the handlers do), then graph_dipole's `run`
    (grid, n_part 10) through its CLI on the 10k cloud; and the card against
    the CPU at 2k for xie and tree_xie."""
    import tempfile

    from dipole_tpu_torch import api
    from dipole_tpu_torch.cli import graph_dipole as gd_cli
    from dipole_tpu_torch.utils.io import write_ply

    agree = {}
    for label, n, method, kw in XIE_RUNS:
        gt = gt10 if n == 10000 else gt30
        inp = scramble(gt, SEED + n)[:, :3].copy()
        _, agree[label] = _patch_run(
            label, lambda timer, inp=inp, method=method, kw=kw: _timed_orient(
                timer, api.orient, inp, method, kw),
            gt, XIE_PATH_KERNELS[method], launches)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ellipsoid10k.ply"
        write_ply(path, gt10[:, :3], gt10[:, 3:6])
        # GT agreement from the metrics `run` prints: count_90 counts the
        # points on the minority side of 90 degrees
        metrics = _kernel_run(
            "graph_dipole10k_grid_cli",
            lambda t: gd_cli.main(["run", "--pc", str(path), "--device", "cuda"],
                                  timer=t),
            ("dipole_imatrix", "greedy_rows", "dipole_potential", "dipole_field"),
            launches, lambda m: {"n": m["total_count"], "metrics": m,
                                 "gt_sign_agreement": 1 - m["count_90"] / m["total_count"]})
    agree["graph_dipole10k_grid_cli"] = 1.0 - metrics["count_90"] / metrics["total_count"]
    for label, a in agree.items():
        require(a >= 0.95, f"{label}: GT sign agreement {a} < 0.95")

    small = scramble(gt10[:2000], SEED + 2)[:, :3].copy()
    for method in ("xie", "tree_xie"):
        on_card = api.orient(small, method=method, device="cuda")
        on_cpu = api.orient(small, method=method, device="cpu")
        same = float(((on_card[:, 3:6] * on_cpu[:, 3:6]).sum(1) > 0).mean())
        emit({"phase": "main_path", "run": f"2k_{method}_card_vs_cpu", "same_sign": same})
        require(same >= 0.999, f"{method}: card and CPU disagree on {1 - same:.6f} "
                               "of signs")
    return agree


SERVE_N = 10000           # tools/serve_bench.py's request size
SERVE_CAP_N = 30000       # the server's admission cap, server_para.MAX_PTS
SERVE_WINDOW_S = 0.05     # the batch leader's window (--microbatch_window_ms 50)
SERVE_XIE = {"max_nn": 30, "eps": 1e-2, "diffuse": False, "times": 3,
             "knn_mask": -1, "C": 3}


def _serve_clients(port, fn, clouds, cfg):
    """One client thread a cloud, all started together: (replies, seconds
    of each request, wall seconds of the wave). A client error fails."""
    from dipole_tpu_torch.serve import protocol

    out, secs, errors = {}, {}, []

    def client(i):
        t0 = time.perf_counter()
        try:
            out[i] = protocol.request("127.0.0.1", port, fn, clouds[i], dict(cfg))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"request {i}: {e!r}")
        secs[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(clouds))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    require(not errors and len(out) == len(clouds), f"serve {fn}: {errors}")
    return [out[i] for i in range(len(clouds))], [secs[i] for i in range(len(clouds))], wall


def _serve_wave(label, srv, fn, clouds, cfg, path_kernels, launches):
    """One wave of concurrent requests through the live server, the launch
    counts reset just before it and read just after; then the same requests
    one after another through handlers.dispatch without a batcher."""
    from dipole_tpu_torch.serve import handlers

    b = srv.batcher
    jobs0, batches0 = b.jobs_run, b.batches_run
    torch.cuda.synchronize()
    _reset_counts()
    replies, secs, wall = _serve_clients(srv.port, fn, clouds, cfg)
    torch.cuda.synchronize()
    counts, plain = _read_counts()
    RUN_COUNTS[label] = counts
    jobs, batches = b.jobs_run - jobs0, b.batches_run - batches0
    t0 = time.perf_counter()
    serial = [handlers.dispatch(fn, xyz, dict(cfg), device="cuda") for xyz in clouds]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    line = {"phase": "serve", "run": label, "function": fn, "requests": len(clouds),
            "n": [len(c) for c in clouds], "wave_seconds": wall,
            "serial_dispatch_seconds": serial_s, "device_jobs": jobs,
            "batches": batches, "jobs_per_batch": jobs / max(batches, 1),
            "latency_p50_s": float(np.median(secs)), "latency_max_s": float(max(secs)),
            "launches": counts, "plain_cuda_calls": plain}
    for name in path_kernels:
        require(counts[name] > 0, f"{label}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{label}: plain version called on CUDA: {plain}")
    return replies, serial, line


def phase_serve(launches) -> dict:
    """The port's threaded server (server_para.Server, micro-batching on) on
    the card, on a loopback port: a wave of 8 concurrent simple_estimate
    requests (diffuse; 8 different scrambled 10000-point ellipsoids, xyz
    only, seeds SEED + 100..107: tools/serve_bench.py's class), then 8
    concurrent tree_xie requests at 10000 points and one at 30000 (the
    admission cap). The waves run twice: with a 50 ms batch window, where
    they must coalesce (fewer batches than device jobs), the simple_estimate
    wave first as the server's first requests (its handler threads' first
    CUDA work) and then again; and on a second server at its default window
    (--microbatch_window_ms 10), where the batches are reported. Each
    simple_estimate reply equals orient_clouds_batched run here on the same
    prepared clouds (the column lanes; or, for a request that ran alone, the
    tiered greedy of a batch of one) with GT agreement >= 0.99; each
    tree_xie reply equals the serial handler with GT agreement >= 0.95.
    Beside each wave, the same requests one after another through
    handlers.dispatch without a batcher."""
    gts = [ellipsoid(SERVE_N, SEED + 100 + i) for i in range(8)]
    clouds = [scramble(g, SEED + 100 + i)[:, :3].astype(np.float64)
              for i, g in enumerate(gts)]
    gt30 = ellipsoid(SERVE_CAP_N, SEED + 108)
    cap = [scramble(gt30, SEED + 108)[:, :3].astype(np.float64)]
    res = _serve_waves(SERVE_WINDOW_S, "", clouds, gts, cap, gt30, launches)
    res.update(_serve_waves(None, "_default_window", clouds, gts, cap, gt30, launches))
    res["host_stages"] = _serve_host_stages(clouds)
    return res


def _serve_waves(window_s, tag, clouds, gts, cap, gt30, launches) -> dict:
    """The waves of phase_serve through one server, its batch window
    window_s (None: the server's default). With a window given, the
    simple_estimate wave runs twice (the server's first requests, then
    again) and every wave must coalesce."""
    import inspect
    import socket
    import tempfile

    from dipole_tpu_torch.ops import propagate
    from dipole_tpu_torch.ops.metrics import sign_agreement
    from dipole_tpu_torch.serve import handlers, protocol
    from dipole_tpu_torch.serve.server_para import Server

    strict = window_s is not None
    if window_s is None:
        window_s = inspect.signature(Server).parameters["microbatch_window_s"].default
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    res = {}

    def coalesced(line, what):
        line["window_s"] = window_s
        emit(line)
        if strict:
            require(line["batches"] < line["device_jobs"],
                    f"{what}: no coalescing ({line['batches']} batches for "
                    f"{line['device_jobs']} jobs)")

    with tempfile.TemporaryDirectory() as logs:
        srv = Server(host="127.0.0.1", port=port, log_dir=logs,
                     microbatch_window_s=window_s, device="cuda")
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            for _ in range(200):        # up: a degenerate request (no device work)
                try:
                    protocol.request("127.0.0.1", port, "simple_estimate",
                                     np.zeros((5, 3)), {}, timeout=10)
                    break
                except OSError:
                    time.sleep(0.05)
            dev = torch.device("cuda")
            # wave 1: simple_estimate (with a window given: the server's
            # first requests, then again)
            if strict:
                first = _serve_wave(f"serve_simple_estimate_8x10k_first{tag}", srv,
                                    "simple_estimate", clouds, {"diffuse": True},
                                    ("greedy_columns_batched",), launches)[2]
                coalesced(first, "serve simple_estimate (first)")
                res[f"simple_estimate_first{tag}"] = first
            # a request that runs alone takes the tiered greedy, not the batched one
            replies, serial, line = _serve_wave(
                f"serve_simple_estimate_8x10k{tag}", srv, "simple_estimate", clouds,
                {"diffuse": True},
                ("greedy_columns_batched", "dipole_potential") if strict
                else ("dipole_potential",), launches)
            prepped = [handlers._prep(xyz, 30, dev) for xyz in clouds]
            lanes = propagate.orient_clouds_batched([p for p, _ in prepped], diffuse=True,
                                                    device=dev)
            agree, alone = [], 0
            for i, (out, (pc, tr)) in enumerate(zip(replies, prepped)):
                want = tr.inverse(lanes[i]).astype(np.float64)
                if not np.array_equal(out, want):
                    one = propagate.orient_clouds_batched([pc], diffuse=True, device=dev)
                    require(np.array_equal(out, tr.inverse(one[0]).astype(np.float64)),
                            f"serve simple_estimate: reply {i} equals neither the "
                            "batched core's lane nor a batch of one")
                    alone += 1
                agree.append(sign_agreement(out, gts[i]))
            line.update(gt_sign_agreement_min=min(agree), replies_from_a_batch_of_one=alone,
                        serial_gt_sign_agreement_min=min(
                            sign_agreement(o, g) for o, g in zip(serial, gts)))
            coalesced(line, "serve simple_estimate")
            require(min(agree) >= 0.99, f"serve simple_estimate: GT agreement {min(agree)}")
            res[f"simple_estimate{tag}"] = line
            # wave 2: tree_xie at 10k, then one request at the admission cap
            replies, serial, line = _serve_wave(
                f"serve_tree_xie_8x10k{tag}", srv, "tree_xie_propagation", clouds,
                SERVE_XIE, ("xie_imatrix", "replay_batched", "dipole_potential"), launches)
            agree = [sign_agreement(o, g) for o, g in zip(replies, gts)]
            same = [np.array_equal(o, w) for o, w in zip(replies, serial)]
            line.update(gt_sign_agreement_min=min(agree), equal_to_serial=all(same))
            coalesced(line, "serve tree_xie")
            require(all(same), f"serve tree_xie: replies differ from the serial handler "
                               f"({same})")
            require(min(agree) >= 0.95, f"serve tree_xie: GT agreement {min(agree)}")
            res[f"tree_xie{tag}"] = line
            replies, serial, line = _serve_wave(
                f"serve_tree_xie_30k{tag}", srv, "tree_xie_propagation", cap, SERVE_XIE,
                ("xie_imatrix", "replay_batched", "dipole_potential"), launches)
            a = sign_agreement(replies[0], gt30)
            line.update(gt_sign_agreement_min=a, window_s=window_s,
                        equal_to_serial=bool(np.array_equal(replies[0], serial[0])))
            emit(line)
            require(line["equal_to_serial"], "serve tree_xie 30k: reply differs from the "
                                             "serial handler")
            require(a >= 0.95, f"serve tree_xie 30k: GT agreement {a}")
            res[f"tree_xie_30k{tag}"] = line
        finally:
            srv.stop()
            th.join(10)
    return res


def _serve_host_stages(clouds) -> dict:
    """The waves' host stages alone, the 8 clouds one after another and in
    8 threads together, as the handler threads run them: normal estimation
    and the transform (handlers._prep), and tree_xie's EMST and BFS orders."""
    from dipole_tpu_torch.ops import propagate
    from dipole_tpu_torch.serve import handlers

    dev = torch.device("cuda")
    prepped = [None] * len(clouds)

    def prep(i):
        prepped[i] = handlers._prep(clouds[i], 30, dev)[0]
        torch.cuda.synchronize()

    def orders(i):
        propagate.bfs_orders(prepped[i], 0, times=3)

    line = {"phase": "serve", "run": "host_stages", "requests": len(clouds)}
    for name, fn in (("prep", prep), ("bfs_orders", orders)):
        t0 = time.perf_counter()
        for i in range(len(clouds)):
            fn(i)
        line[f"{name}_serial_s"] = time.perf_counter() - t0
        threads = [threading.Thread(target=fn, args=(i,)) for i in range(len(clouds))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        line[f"{name}_threads_s"] = time.perf_counter() - t0
    emit(line)
    return line


def phase_timing_serve(dev, full_grid_a_us: float) -> dict:
    """The batched entries at the waves' shape: one batched launch against
    B single launches at B = 2, 4 and 8 clouds of 10000 points (CUDA
    events, in turns), the B = 8 lanes held to the single launches and to
    the plain versions (a lane after another, timed once): the greedy's
    acc and sign bit-equal, the replay's w equal, its flips identical and
    inter within 1e-6 of sum |I w|; the greedy's bound
    by operations, with the exchange's time a step on 132 blocks (the
    full-grid fit's intercept) times the steps beside it, the replay's by
    bytes."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.serve import handlers

    n = SERVE_N
    prepped = [handlers._prep(scramble(ellipsoid(n, SEED + 100 + i), SEED + 100 + i)
                              [:, :3], 30, dev)[0] for i in range(8)]
    pts = [torch.as_tensor(p, device=dev) for p in prepped]
    res = {}
    greedy = {"B": {}}
    for B in (2, 4, 8):
        p = pts[:B]
        batched = cuda_ms(lambda: propagate_cuda.greedy_columns_batched(p, [0] * B, 1e-6),
                          3, 1)
        single = cuda_ms(lambda: [propagate_cuda.greedy_columns(q, 0, 1e-6) for q in p],
                         3, 1)
        again = cuda_ms(lambda: propagate_cuda.greedy_columns_batched(p, [0] * B, 1e-6),
                        3, 0)
        greedy["B"][B] = {"batched_ms": [batched, again], "single_launches_ms": single,
                          "launches": propagate_cuda.last_launch()["launches"]}
    got = propagate_cuda.greedy_columns_batched(pts, [0] * 8, 1e-6)
    for q, (a, sg) in zip(pts, got):
        one = propagate_cuda.greedy_columns(q, 0, 1e-6)
        require(torch.equal(a, one[0]) and torch.equal(sg, one[1]),
                "greedy_columns_batched: a lane differs from its single launch at 8 x 10k")
    plain_ms, want = timed(lambda: [propagate.greedy_columns_plain(q, 0, 1e-6) for q in pts])
    err = max(_equal("greedy_columns_batched", (a, sg), w, lane=i, shape=f"8 x {n}",
                     main_path_shape=True)
              for i, ((a, sg), w) in enumerate(zip(got, want)))
    b = bound_ms(8 * (24 * n + 8 * n), 8 * OPS_GREEDY_COLUMN * n * (n - 1))
    res["greedy_columns_batched"] = dict(
        shape=f"8 clouds x {n} points, column mode", ms=greedy["B"][8]["batched_ms"][0],
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], max_abs_err=err,
        single_launches_ms=greedy["B"][8]["single_launches_ms"],
        step_floor_132_blocks_ms=full_grid_a_us * (n - 1) / 1e3, by_batch=greedy["B"])
    del got, want

    orders = [torch.as_tensor(propagate.bfs_orders(p, 0, times=3)[0], device=dev)
              for p in prepped]
    mats = [fields.xie_interaction_matrix(q) for q in pts]
    replay = {"B": {}}
    for B in (2, 4, 8):
        m, o = mats[:B], orders[:B]
        batched = cuda_ms(lambda: propagate_cuda.replay_batched(m, o), 3, 1)
        single = cuda_ms(lambda: [propagate_cuda.replay(I, oo) for I, oo in zip(m, o)], 3, 1)
        again = cuda_ms(lambda: propagate_cuda.replay_batched(m, o), 3, 0)
        replay["B"][B] = {"batched_ms": [batched, again], "single_launches_ms": single}
    got = propagate_cuda.replay_batched(mats, orders)
    for I, o, (w, inter) in zip(mats, orders, got):
        w1, i1 = propagate_cuda.replay(I, o)
        require(torch.equal(w, w1) and torch.equal(inter, i1),
                "replay_batched: a lane differs from its single replay at 8 x 10k")
    plain_ms, want = timed(lambda: [propagate.replay_plain(I, o) for I, o in zip(mats, orders)])
    rel = [_replay_lane_vs_plain(f"lane {i} of 8 x {n}", I, o, w, inter, wp, ip)
           for i, (I, o, (w, inter), (wp, ip)) in enumerate(zip(mats, orders, got, want))]
    err = max(float((i - wi).abs().max()) for (_, i), (_, wi) in zip(got, want))
    emit({"phase": "check", "kernel": "replay_batched", "case": f"8 x {n}",
          "main_path_shape": True, "decisions_equal_plain": True,
          "max_err_over_sum_abs": max(rel), "max_abs_err": err})
    T = 3
    b = bound_ms(8 * (4 * n * n + 4 * T * n + 12 * T * n), 8 * OPS_REPLAY * T * n * n)
    res["replay_batched"] = dict(
        shape=f"8 clouds x {T} orders x {n} points", ms=replay["B"][8]["batched_ms"][0],
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], max_abs_err=err,
        single_launches_ms=replay["B"][8]["single_launches_ms"], by_batch=replay["B"])
    del mats, got, want
    emit({"phase": "timing", "batched_kernels": res})
    return res


def _timed_orient(timer, orient, inp, method, kw):
    with timer(f"orient {method}"):
        return orient(inp, method=method, device="cuda", **kw)


def phase_timing_xie(gt10, gt30, dev) -> dict:
    """The xie slice's kernels at the main path's shapes: the xie matrix at
    30k (tree_xie, I) and 10k (xie, I^T), the xie greedy at 10k, masked
    (k = 8) at 10k and at 30k, with its one-block limit, the replay of the
    tree_xie run's three BFS orders at 30k; the kernel held to its plain
    version there too."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
    from dipole_tpu_torch.ops.estimate import estimate_normals
    from dipole_tpu_torch.utils.io import Transform

    res = {}
    # the handlers' input: estimated normals, then normalized
    pc30 = Transform.trans(estimate_normals(scramble(gt30, SEED + 30000)[:, :3],
                                            device=dev))[0]
    pc10 = Transform.trans(estimate_normals(scramble(gt10, SEED + 10000)[:, :3],
                                            device=dev))[0]
    p30 = torch.as_tensor(pc30, device=dev)
    p10 = torch.as_tensor(pc10, device=dev)
    n30, n10 = len(p30), len(p10)

    sizes = {}
    for label, p, transposed in (("30k_I", p30, False), ("10k_IT", p10, True)):
        n = len(p)
        I = fields.xie_interaction_matrix(p, transposed=transposed)
        plain_ms, want = timed(
            lambda: fields.xie_interaction_matrix_plain(p, p, 3.0, transposed))
        err = _equal("xie_imatrix", I, want, n=n, transposed=transposed,
                     main_path_shape=True)
        del want
        b = bound_ms(24 * 2 * n + 4 * n * n, OPS_XIE * n * n)
        sizes[label] = dict(
            shape=f"{n} x {n}" + (", transposed" if transposed else ""),
            max_abs_err=err, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            ms=cuda_ms(lambda: fields.xie_interaction_matrix(p, transposed=transposed),
                       5, 1))
        del I
    # the general mode (targets given) at the 30k shape: no mirror
    I = fields.xie_interaction_matrix(p30)
    require(torch.equal(fields.xie_interaction_matrix(p30, targets=p30), I),
            "xie_imatrix: the general mode differs from the symmetric one at 30k")
    del I
    sizes["30k_I_general"] = dict(
        shape=f"{n30} x {n30}, targets given",
        ms=cuda_ms(lambda: fields.xie_interaction_matrix(p30, targets=p30), 5, 1))
    res["xie_imatrix"] = {**sizes["30k_I"], "other_shapes": {
        "10k_IT": sizes["10k_IT"], "30k_I_general": sizes["30k_I_general"]}}

    res["greedy_xie"] = time_xie_greedy(
        (("10k", p10, None), ("10k_masked_k8", p10, propagate._knn_idx(pc10, 8)),
         ("30k", p30, None)), (2048, 3072, 4096, 5120, 6144, 7168, 8192))

    orders_np, _ = propagate.bfs_orders(pc30, 0, times=3)
    orders = torch.as_tensor(orders_np, device=dev)
    I = fields.xie_interaction_matrix(p30)
    T = orders.shape[0]
    err = check_replay(dict(n=n30, T=T, matrix="xie", main_path_shape=True),
                       I, orders, None, None)
    plain_ms, _ = timed(lambda: propagate.replay_plain(I, orders))
    # each input read once: I, the orders; each output written once: w, inter
    b = bound_ms(4 * n30 * n30 + 4 * T * n30 + 12 * T * n30,
                 OPS_REPLAY * T * n30 * n30)
    ms = cuda_ms(lambda: propagate_cuda.replay(I, orders), 3, 0)
    res["replay"] = dict(
        shape=f"{T} orders x {n30} points",
        blocks=propagate_cuda.last_launch()["blocks"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        bytes_read_by_this_design=4 * T * n30 * n30,
        bytes_bound_ms=4 * T * n30 * n30 / PEAK_BYTES_PER_S * 1e3,
        profile=_profile_replay(I, orders))
    del I
    # graph_dipole's vote count: 9 orders of a 10k cloud
    orders9 = torch.as_tensor(propagate.bfs_orders(pc10, 0, times=9)[0], device=dev)
    I = fields.xie_interaction_matrix(p10)
    res["replay"]["ms_9_orders_10k"] = cuda_ms(
        lambda: propagate_cuda.replay(I, orders9), 3, 1)
    del I
    emit({"phase": "timing", "xie_kernels": res})
    return res


def time_xie_greedy(runs, threshold_sizes) -> dict:
    """The xie greedy at each (label, cloud, kNN index or None) of runs,
    held to its plain version, with its bound; the first run's entry
    carries the others and one block against a grid of ceil(n / 1024)
    blocks at each of threshold_sizes (points of the first cloud)."""
    from dipole_tpu_torch.ops import fields, propagate, propagate_cuda

    xie = {}
    for label, p, knn_np in runs:
        n = len(p)
        knn = None if knn_np is None else torch.as_tensor(knn_np, device=p.device)
        IT = fields.xie_interaction_matrix(p, transposed=True)
        got = propagate_cuda.xie_greedy(IT, 0, knn)
        blocks = propagate_cuda.last_launch()["blocks"]
        plain_ms, want = timed(lambda: propagate.xie_greedy_plain(IT, 0, knn))
        # masked, the loop needs only the mask's n k entries of IT and the
        # mask itself
        k = 0 if knn is None else knn.shape[1]
        b = bound_ms((4 * n * n if not k else 8 * n * k) + 12 * n,
                     OPS_GREEDY_XIE * n * (n - 1))
        ms = cuda_ms(lambda: propagate_cuda.xie_greedy(IT, 0, knn), 3, 0)
        xie[label] = dict(
            shape=f"{n} points" + (f", kNN mask k={k}" if k else ""),
            blocks=blocks, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            max_abs_err=_equal("greedy_xie", got, want, n=n, knn_mask=k,
                               main_path_shape=True),
            ms=ms, us_per_step=1e3 * ms / (n - 1))
        del IT, want
    first = runs[0][1]
    threshold = []
    for n in threshold_sizes:
        IT = fields.xie_interaction_matrix(first[:n].contiguous(), transposed=True)
        for blocks in (1, -(-n // 1024)):
            ms = cuda_ms(lambda: propagate_cuda.xie_greedy(IT, 0, _blocks=blocks), 3, 1)
            threshold.append({"n": n, "ms": ms, "us_per_step": 1e3 * ms / (n - 1),
                              **propagate_cuda.last_launch()})
        del IT
    label = runs[0][0]
    return {**xie[label], "other_shapes": {k: v for k, v in xie.items() if k != label},
            "one_block_threshold": threshold}


def _profile_replay(I, orders) -> dict:
    """One unmasked replay under torch.profiler: launches and device time of
    its bulk and decision kernels, and the share of the call's wall that the
    device sat idle (the gaps between the launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipole_tpu_torch.ops import propagate_cuda

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        propagate_cuda.replay(I, orders)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernels = {("bulk" if "bulk" in e.key else "decisions"): dict(
        launches=e.count, ms=e.self_device_time_total / 1e3,
        us_each=e.self_device_time_total / max(e.count, 1))
        for e in events if "replay_" in e.key}
    return {"profiled_wall_ms": wall_ms, "kernels": kernels,
            "device_idle_share": 1 - busy_ms / wall_ms}


def _mxu_fns(name):
    from dipole_tpu_torch.ops import fields_cuda
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    return getattr(fields_cuda, name), getattr(mxu, f"{name}_plain")


def _mxu_control(name, s, t):
    """The one-pass control (MXU_CONTROL, built in the build phase) on s, t."""
    import ctypes

    lib = ctypes.CDLL(str(MXU_CONTROL))
    P, N = ctypes.c_void_p, ctypes.c_int
    lib.dipole_field_mma_chunks.restype = N
    lib.dipole_field_mma_chunks.argtypes = [N, N]
    fn = getattr(lib, f"dipole_{name}")
    fn.restype = N
    fn.argtypes = [P, N, P, N, ctypes.c_float, P, P, P]
    m, n = s.shape[0], t.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=t.device)
    partial = torch.empty(lib.dipole_field_mma_chunks(m, n) * n * 3,
                          dtype=torch.float32, device=t.device)
    err = fn(s.data_ptr(), m, t.data_ptr(), n, 1e-5, partial.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"{name} control: CUDA error {err}")
    return out


def _mxu_check(name, s, t, rtol, failures, got=None, want=None, scale=None,
               control=True, **info) -> dict:
    """The kernel (or `got`) against its plain version (or `want`) per
    target, |kernel - plain| <= rtol S_t with S_t = sum_s (|b||p| + |a|(|s|
    + |t|)); with `control`, the one-pass control's reading against the same
    limit too. Emit the check line, add a failure to `failures` and return
    the line."""
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    kernel, plain = _mxu_fns(name)
    got = kernel(s, t, 1e-5) if got is None else got
    want = plain(s, t, 1e-5) if want is None else want
    scale = mxu.tolerance_scale(s, t) if scale is None else scale

    def over_tol(out):
        return float(((out - want).abs().double() / (rtol * scale[:, None])).max())

    line = {"phase": "check", "kernel": name, "rtol_of_sum_abs_terms": rtol,
            "max_abs_err": float((got - want).abs().max()),
            "max_err_over_tol": over_tol(got),
            "finite": bool(torch.isfinite(got).all()), **info}
    if control:
        line["control_1pass_max_err_over_tol"] = over_tol(_mxu_control(name, s, t))
    emit(line)
    if not (line["finite"] and line["max_err_over_tol"] <= 1.0):
        failures.append(f"{name}: error {line['max_err_over_tol']} x its tolerance ({info})")
    return line


def phase_checks_mxu(dev):
    """The tensor-core field variants against their plain versions, the
    one-pass control against the same limits. On the tool's data at 4096 x
    3001 and 777 x 20000 (several 512-source chunks, S not a multiple of
    512): the exact variant also with a target on a source (that pair gives
    0: the field of the other sources) and duplicate sources; the expansion
    where no pair is nearer than MXU_APART (near a coincident pair its r^2
    cancels, its documented behaviour). Then both on the tool's own data at
    its full shape, the plain versions timed there (one call each). The
    one-pass control must fail at least one check of each variant.
    Returns ({name: max abs difference}, {name: plain ms})."""
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    exact, expansion = "field_mxu_exact", "field_mxu_expansion"
    errs = {exact: 0.0, expansion: 0.0}
    control = {exact: 0.0, expansion: 0.0}
    failures = []

    def check(name, *args, **kw):
        line = _mxu_check(name, *args, failures, **kw)
        errs[name] = max(errs[name], line["max_abs_err"])
        control[name] = max(control[name], line.get("control_1pass_max_err_over_tol", 0.0))
    for n_tgt, n_src in ((4096, 3001), (777, 20000)):
        src, tgt, _ = mxu.tool_data(n_tgt, n_src)
        s = torch.as_tensor(src, device=dev)
        t = torch.as_tensor(tgt, device=dev)
        s[n_src - 64:] = s[:64]                       # duplicate sources
        t[0] = s[100, :3]                             # a target on a source
        info = dict(targets=n_tgt, sources=n_src)
        check(exact, s, t, MXU_RTOL[exact], duplicates=64, target_on_source=True,
              **info)
        kernel, _ = _mxu_fns(exact)
        check(exact, torch.cat([s[:100], s[101:]]), t[:1], MXU_RTOL[exact],
              got=kernel(s, t[:1], 1e-5), control=False,
              what="the target on a source against the field of the other sources",
              **info)
        d = torch.cdist(t.double(), s[:, :3].double()).min(1).values
        t = torch.where((d < MXU_APART)[:, None], t + 10.0, t)
        check(expansion, s, t, MXU_RTOL[expansion], min_pair_distance=MXU_APART,
              **info)
    n_tgt, n_src = MXU_SHAPE
    src, tgt, _ = mxu.tool_data(n_tgt, n_src)
    s = torch.as_tensor(src, device=dev)
    t = torch.as_tensor(tgt, device=dev)
    scale = mxu.tolerance_scale(s, t)
    plain_ms = {}
    for name in (exact, expansion):
        _, plain = _mxu_fns(name)
        plain_ms[name], want = timed(lambda: plain(s, t, 1e-5))
        rtol = MXU_RTOL[exact] if name == exact else MXU_RTOL_NEAR_PAIRS
        check(name, s, t, rtol, want=want, scale=scale,
              data="the tool's, near pairs included", targets=n_tgt, sources=n_src)
    failures += [f"{name}: the one-pass control passes every check ({v} x)"
                 for name, v in control.items() if not v > 1.0]
    require(not failures, "; ".join(failures))
    return errs, plain_ms


def phase_main_path_mxu(launches) -> dict:
    """The tool, `python -m dipole_tpu_torch.tools.mxu_field_experiment`,
    through its main() at its full shape: the three variants, warm-up + best
    of 5 each; the exact variant within 1e-3 of max|E| of "current" and 0.999
    of its interaction signs (the expansion's lines are reported as the
    tool prints them)."""
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    n_tgt, n_src = MXU_SHAPE
    res = _kernel_run(
        f"mxu_field_experiment_{n_tgt}x{n_src}",
        lambda timer: mxu.main(n_tgt, n_src, device="cuda"),
        ("field_mxu_exact", "field_mxu_expansion", "dipole_field"), launches,
        lambda r: {"tool": r})
    for name, v in res["gpairs_per_s"].items():
        require(np.isfinite(v) and v > 0, f"tool: {name} GPairs/s {v}")
    require(res["rel_max_diff"]["mxu_exact"] <= 1e-3
            and res["sign_agreement"]["mxu_exact"] >= 0.999,
            f"tool: mxu_exact off current: {res}")
    return res


def _mxu_panel(dev):
    from dipole_tpu_torch.tools import mxu_field_experiment as mxu

    src, tgt, _ = mxu.tool_data(*MXU_SHAPE)
    return torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)


def phase_timing_mxu(tool: dict, plain_ms: dict, dev) -> dict:
    """Rows 11-12 at the tool's shape: each kernel's ms from the tool's run
    (best of 5 by CUDA events) and by the profiler's device time (both of
    its kernels), field.cu's device time at the same panel and the ratio,
    its plain version's ms from the checks phase, and its bound: the
    CUDA-core pair math at the fp32 peak against the 3xTF32 products at the
    TF32 peak."""
    from dipole_tpu_torch.ops import fields_cuda

    n_tgt, n_src = MXU_SHAPE
    pairs = n_tgt * n_src
    s, t = _mxu_panel(dev)
    field_ms = profiled_ms(lambda: fields_cuda.field_grad(s, t, 1e-5),
                           ("field_partial", "field_finish"), 5)
    res = {}
    for name, (cuda_ops, tc_ops) in OPS_MXU.items():
        b = bound_ms(24 * n_src + 12 * n_tgt + 12 * n_tgt, cuda_ops * pairs,
                     TF32_PASSES * tc_ops * pairs)
        fn = getattr(fields_cuda, name)
        prof = profiled_ms(lambda: fn(s, t, 1e-5),
                           ("field_mma_partial", "field_finish"), 5)
        res[name] = dict(shape=f"{n_tgt} targets x {n_src} sources",
                         ms=tool["ms"][name.removeprefix("field_")],
                         profiled_ms=prof, over_field_cu=prof / field_ms,
                         plain_ms=plain_ms[name], bound_ms=b[0], bound_by=b[1])
    emit({"phase": "timing", "mxu_kernels": res,
          "dipole_field_at_tool_shape_ms": tool["ms"]["current"],
          "dipole_field_at_tool_shape_profiled_ms": field_ms})
    return res



# ---- the training slice: PointCNN training and the torch_rng replay ----

TRAIN_RECIPE_A = dict(region_flip=0.9, region_draws=2, point_flip=0.4,
                      scramble=0.0, class_balance=True, gauge_free=True)
TRAIN_KW = dict(steps=40, batch=16, bucket=512, pool=0.6, learning_rate=1e-3)


def _mined_states() -> list:
    """train_data/mined_states_r4.npz's 199 (patch, labels) states."""
    z = np.load(ROOT / "train_data" / "mined_states_r4.npz")
    off = np.concatenate([[0], np.cumsum(z["lengths"])])
    return [(z["points"][a:b], z["labels"][a:b]) for a, b in zip(off[:-1], off[1:])]


def _step_split_timer():
    """A timer for train_on_clouds' timer= hook: each part of each step
    (assembly, forward, backward, optimizer) ended by a synchronize, its
    seconds kept per step in `timer.parts`."""
    import contextlib

    parts = {"assembly": [], "forward": [], "backward": [], "optimizer": []}

    @contextlib.contextmanager
    def timer(label):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        parts[label].append(time.perf_counter() - t0)

    timer.parts = parts
    return timer


def _split_summary(parts: dict) -> dict:
    """The first step's seconds and the median ms of steps 5 on, per part
    and for the whole step (the parts' sum)."""
    parts = dict(parts, step=list(np.sum([parts[k] for k in parts], axis=0)))
    return {"first_step_s": {k: v[0] for k, v in parts.items()},
            "median_ms_steps_5_on": {k: float(np.median(v[5:])) * 1e3
                                     for k, v in parts.items()}}


def _profile_step(model, data, dev) -> dict:
    """One training step (assembly on the host, forward, backward,
    optimizer) under torch.profiler: the device's idle share of the step's
    wall time and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipole_tpu_torch import train
    from dipole_tpu_torch.models.pointcnn import _pad_sizes, key_starts
    from dipole_tpu_torch.utils import prng

    bucket, pool = TRAIN_KW["bucket"], TRAIN_KW["pool"]
    _opt, step = train.make_train_step(model, TRAIN_KW["learning_rate"], 40,
                                       class_balance=True, gauge_free=True)
    rng = np.random.default_rng(SEED + 41)
    m1, _ = _pad_sizes(bucket, pool)

    def one():
        pc, lab, valid = train.assemble_batch(data, TRAIN_KW["batch"], bucket, rng)
        return step(pc, lab, valid, key_starts(prng.prng_key(SEED + 41),
                                               valid.sum(1), pool, m1))

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def _plain_searches():
    """pointcnn's kNN and FPS swapped for their plain versions (the
    kernel-against-plain step); returns the restore function."""
    from dipole_tpu_torch.models import pointcnn
    from dipole_tpu_torch.ops import neighbors

    saved = (pointcnn.knn_with_dist, pointcnn.fps_masked_batch)
    pointcnn.knn_with_dist = neighbors.knn_with_dist_plain
    pointcnn.fps_masked_batch = neighbors.fps_masked_batch_plain

    def restore():
        pointcnn.knn_with_dist, pointcnn.fps_masked_batch = saved
    return restore


def _step_kernel_vs_plain(model, data, dev) -> dict:
    """One loss and backward with the kNN and FPS kernels and one with their
    plain versions, from the same parameters and batch. Both kernels are
    bit-equal to their plain versions, so the two graphs are the same, and
    the backward is deterministic: the gathers' backward is index_put's
    accumulate, which sorts its indices (indexing_backward_kernel, no
    atomics). The loss and every gradient are held bit-equal, which is
    inside the 1e-6 (loss, relative) and 1e-5 (of max |g|) limits.
    torch.use_deterministic_algorithms is not switched on."""
    import copy

    from dipole_tpu_torch import train
    from dipole_tpu_torch.models.pointcnn import _pad_sizes, key_starts
    from dipole_tpu_torch.utils import prng

    bucket, pool = TRAIN_KW["bucket"], TRAIN_KW["pool"]
    rng = np.random.default_rng(SEED + 42)
    pc, lab, valid = train.assemble_batch(data, TRAIN_KW["batch"], bucket, rng,
                                          region_flip=0.9, point_flip=0.4)
    starts = key_starts(prng.prng_key(SEED + 42), valid.sum(1), pool,
                        _pad_sizes(bucket, pool)[0])
    out = {}
    for label in ("kernel", "plain"):
        m = copy.deepcopy(model)
        restore = _plain_searches() if label == "plain" else (lambda: None)
        try:
            loss, _ = train.loss_fn(m, torch.as_tensor(pc, device=dev),
                                    torch.as_tensor(lab, device=dev),
                                    torch.as_tensor(valid, device=dev), starts,
                                    class_balance=True, gauge_free=True)
            loss.backward()
        finally:
            restore()
        out[label] = (float(loss.detach()), {k: p.grad for k, p in m.named_parameters()
                                    if p.grad is not None})
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(float((gk[k] - gp[k]).abs().max()) / max(float(gp[k].abs().max()), 1e-30)
                   for k in gp)
    require(set(gk) == set(gp), "kernel and plain steps differ in their gradients")
    require(lk == lp, f"train step: kernel loss {lk} against plain {lp}")
    require(grad_rel == 0.0, f"train step: gradients differ by {grad_rel} of max |g|")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
            "grad_max_rel_diff": grad_rel, "bit_equal": True}


def _fixed_batch(dev, mesh=None) -> dict:
    """tests/test_train_checkpoint.py:64-91 on the card at full width: a
    fixed 16 x 512 make_batch, 60 steps at lr 3e-3 from the calibrated
    init, fixed FPS starts, on one device or under `mesh`; max(acc of the
    last 10) > min(0.95, base + 0.15)."""
    from dipole_tpu_torch import train
    from dipole_tpu_torch.models.pointcnn import _pad_sizes, key_starts
    from dipole_tpu_torch.utils import prng

    n, pool = TRAIN_KW["bucket"], TRAIN_KW["pool"]
    model = train._fresh_model(prng.prng_key(0), train._probe_patch(0, n), pool, dev)
    _opt, step = train.make_train_step(model, 3e-3, total_steps=60, mesh=mesh)
    pc, labels, valid = train.make_batch(prng.prng_key(1), TRAIN_KW["batch"], n)
    starts = key_starts(prng.prng_key(2), valid.sum(1), pool, _pad_sizes(n, pool)[0])
    accs = [float(step(pc, labels, valid, starts)[1]) for _ in range(60)]
    base = float(labels.mean())
    require(max(accs[-10:]) > min(0.95, base + 0.15),
            f"fixed batch: accuracy {accs[-10:]} against base {base}")
    return {"shape": [TRAIN_KW["batch"], n], "base": base, "acc_last_10": accs[-10:]}


def _reload_logits(model, data, dev) -> dict:
    """save_state_dict -> PointCNN.from_files -> pointcnn_logits_batched:
    the reloaded model's logits bit-equal to the model in memory's."""
    import tempfile

    from dipole_tpu_torch.models import checkpoints, pointcnn

    patches = [p for p, _ in data[:64]]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trained.pt"
        checkpoints.save_state_dict(model.state_dict(), path)
        path.with_suffix(".txt").write_text(f"pool: {TRAIN_KW['pool']}\n")
        back = pointcnn.PointCNN.from_files(path).to(dev)
    got = pointcnn.pointcnn_logits_batched(back, patches)
    want = pointcnn.pointcnn_logits_batched(model, patches)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    require(same, "reloaded checkpoint: logits differ from the model in memory")
    require(back.content_digest == model.content_digest, "reloaded digest differs")
    return {"patches": len(patches), "bit_equal": same}


def phase_train(hand10: np.ndarray, launches, dev) -> dict:
    """PointCNN training on the card: train_on_clouds with the fixers'
    recipe A (tools/train_r6.py:41-42, :94-99) at batch 16, bucket 512,
    pool 0.6, lr 1e-3, 40 steps, on the 199 mined states
    (train_data/mined_states_r4.npz) and the 10k metaball hand (exact
    normals) written as a .xyz and patched by patches_from_cloud; launch
    counts reset just before and read just after, and the launches of its
    second step read from their difference at the step's two snapshots.
    Before it, the same call with a synchronizing timer= takes each step
    apart; after it, one step traced, the kernel-against-plain step, the
    fixed-batch criterion and the checkpoint round trip."""
    import tempfile

    from dipole_tpu_torch import train
    from dipole_tpu_torch.utils.io import export_pc

    mined = _mined_states()
    stamps, step_counts = [], []

    def snap(step, _model):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if step <= 2:
            step_counts.append(_read_counts()[0])

    with tempfile.TemporaryDirectory() as tmp:
        hand = Path(tmp) / "hand10k.xyz"
        export_pc(hand10, hand)
        data = mined + train.patches_from_cloud(hand, device=dev)
        timer = _step_split_timer()
        train.train_on_clouds([str(hand)], extra_data=mined, verbose=False,
                              device=dev, timer=timer, **TRAIN_KW, **TRAIN_RECIPE_A)
        split = _split_summary(timer.parts)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        model, history, _ = train.train_on_clouds(
            [str(hand)], extra_data=mined, verbose=False, device=dev,
            snapshot_every=1, snapshot_fn=snap, **TRAIN_KW, **TRAIN_RECIPE_A)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, plain = _read_counts()
    label = "train_on_clouds_recipe_a"
    RUN_COUNTS[label] = counts
    for name in ("knn", "fps"):
        require(counts[name] > 0, f"{label}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{label}: plain version called on CUDA: {plain}")
    losses = [h[0] for h in history]
    require(len(history) == TRAIN_KW["steps"] and bool(np.isfinite(losses).all()),
            f"{label}: non-finite loss {losses}")
    split["launches_per_step"] = {k: step_counts[1][k] - step_counts[0][k]
                                  for k in ("knn", "fps")}
    step_ms = np.diff(stamps) * 1e3
    res = {"phase": "train", "run": label, "card": CARD.get("nvidia_smi"),
           **TRAIN_KW, "recipe": TRAIN_RECIPE_A,
           "patches": len(data), "mined_states": len(mined), "seconds": wall,
           "step_ms_median_steps_5_on_unsynced": float(np.median(step_ms[4:])),
           "history": history, "launches": counts, "plain_cuda_calls": plain}
    res["split"] = split
    res["profile_one_step"] = _profile_step(model, data, dev)
    res["kernel_vs_plain"] = _step_kernel_vs_plain(model, data, dev)
    res["fixed_batch"] = _fixed_batch(dev)
    res["reload"] = _reload_logits(model, data, dev)
    emit(res)
    return res


def phase_torch_rng(hand10: np.ndarray, launches, dev) -> dict:
    """api.orient_patches on the 10k hand with the v1 trio, the hand demo's
    flags and torch_rng=1, twice: identical outputs, GT agreement >= 0.9;
    the draws it made come from the reference's stream, whose first 32
    randint(1000) are TORCH_RNG_FIRST_32."""
    from dipole_tpu_torch import api
    from dipole_tpu_torch.ops.metrics import sign_agreement
    from dipole_tpu_torch.utils.timing import timer_factory
    from dipole_tpu_torch.utils.torch_rng import TorchMT19937

    first = TorchMT19937(1)
    first = tuple(first.randint(1000) for _ in range(32))
    require(first == TORCH_RNG_FIRST_32, f"torch_rng stream {first}")
    draws = []

    class Recording(TorchMT19937):
        def randint(self, n):
            v = super().randint(n)
            draws.append((n, v))
            return v

    models = [str(m) for m in MODELS]
    runs, seconds = [], []
    api.TorchMT19937, saved = Recording, api.TorchMT19937
    try:
        for i in range(2):
            timer = timer_factory()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            runs.append(api.orient_patches(hand10[:, :3].copy(), models=models,
                                           timer=timer, device=dev, torch_rng=1,
                                           **HAND_FLAGS))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                counts, plain = _read_counts()
                n_draws = len(draws)
    finally:
        api.TorchMT19937 = saved
    label = "hand10k_orient_patches_torch_rng"
    RUN_COUNTS[label] = counts
    for name in ("dipole_group", "knn", "fps", "dipole_potential"):
        require(counts[name] > 0, f"{label}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{label}: plain version called on CUDA: {plain}")
    replay = TorchMT19937(1)
    require(n_draws > 0 and all(replay.randint(n) == v for n, v in draws[:n_draws]),
            "torch_rng: the run's draws are not the seed-1 stream")
    require(draws[:n_draws] == draws[n_draws:], "torch_rng: the runs drew differently")
    same = bool(np.array_equal(runs[0], runs[1]))
    agree = sign_agreement(runs[0], hand10)
    res = {"phase": "torch_rng", "run": label, "card": CARD.get("nvidia_smi"),
           "seconds": seconds, "stages": timer.stages,
           "identical_runs": same, "gt_sign_agreement": agree, "draws_per_run": n_draws,
           "first_draws": draws[:6], "stream_first_32_n1000": list(first),
           "launches": counts, "plain_cuda_calls": plain}
    emit(res)
    require(same, "torch_rng: two runs differ")
    require(agree >= 0.9, f"torch_rng: GT sign agreement {agree} < 0.9")
    return res


MESH_SHARDS = 4           # the virtual mesh: the one card named four times
MESH_NOTE = ("virtual mesh: the shards share one card, so its times measure "
             "the shard code (collectives are copies on one card), not NVLink")


def _synced(fn):
    """(seconds, result) of fn() between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _field_ratio(got, want) -> float:
    """The worst component's |got - want| over the field's tolerance, 1e-4
    |E| + 1e-5 max|E| (ops/fields_cuda.field_grad)."""
    got = torch.as_tensor(np.asarray(got), device=want.device)
    tol = 1e-4 * want.abs() + 1e-5 * float(want.abs().max())
    return float(((got - want).abs() / tol).max())


def _within(ratio: float):
    """A check's (ok, report) for a worst-entry tolerance ratio."""
    return ratio <= 1.0, {"tolerance_ratio": ratio}


def _same_sign(a: np.ndarray, b: np.ndarray) -> float:
    return float(((a[:, 3:6] * b[:, 3:6]).sum(1) > 0).mean())


def _oriented(gt, floor: float, equal: bool = False, agree: float = 0.0):
    """The check of an oriented cloud against its one-device run: GT
    agreement >= floor, and equal to the one-device output (equal) or on
    the same side for >= agree of the points."""
    from dipole_tpu_torch.ops.metrics import sign_agreement

    def check(got, want):
        a, g = _same_sign(got, want), sign_agreement(got, gt)
        ok = g >= floor and (bool(np.array_equal(got, want)) if equal else a >= agree)
        return ok, {"equal_to_one_device": bool(np.array_equal(got, want)),
                    "agreement_with_one_device": a, "gt_sign_agreement": g}
    return check


def _mesh_run(mesh_label, run, sharded, single, check, path_kernels, launches,
              **info):
    """One sharded run: the one-device run first (its seconds beside), then
    launch counts reset just before the sharded call and read just after;
    check(got, want) -> (ok, report); each path kernel launched on the mesh,
    no plain version called on a CUDA tensor."""
    single_s, want = _synced(single)
    _reset_counts()
    secs, got = _synced(sharded)
    counts, plain = _read_counts()
    label = f"mesh_{mesh_label}_{run}"
    RUN_COUNTS[label] = counts
    ok, report = check(got, want)
    emit({"phase": "mesh", "mesh": mesh_label, "run": run, "seconds": secs,
          "single_device_seconds": single_s, **report, **info,
          "launches": {k: v for k, v in counts.items() if v},
          "plain_cuda_calls": plain, "card": CARD.get("nvidia_smi"),
          **({"note": MESH_NOTE} if mesh_label.startswith("virtual") else {})})
    require(ok, f"{label}: {report}")
    for name in path_kernels:
        require(counts[name] > 0, f"{label}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{label}: plain version called on CUDA: {plain}")
    return got, want, secs


def _mesh_kernels(mesh, mesh_label, hand_out, hand180, cloud180, lion_reps,
                  launches, dev) -> None:
    """The sharded kernel paths: the field in its three modes at the
    transfer's 10000 sources x 180000 targets, the potential (sources and
    ring) at the sign fix's 180000 x 1000, the group at the lion's
    representatives (bit-equal to the one-device call)."""
    from dipole_tpu_torch.ops import fields
    from dipole_tpu_torch.parallel import sharding
    from dipole_tpu_torch.utils.io import gen_grid

    src = torch.as_tensor(hand_out, device=dev)
    tgt = torch.as_tensor(hand180[:, :3].copy(), device=dev)
    for mode in ("targets", "sources", "ring"):
        _mesh_run(mesh_label, f"field_{mode}",
                  lambda mode=mode: sharding.field_grad_sharded(src, tgt, mesh, shard=mode),
                  lambda: fields.field_grad(src, tgt),
                  lambda got, want: _within(_field_ratio(got, want)),
                  ("dipole_field",), launches, shape="10000 x 180000")
    grid = torch.as_tensor(gen_grid(10), device=dev)
    for mode in ("sources", "ring"):
        _mesh_run(mesh_label, f"potential_{mode}",
                  lambda mode=mode: sharding.potential_sharded(cloud180, grid, mesh,
                                                               shard=mode),
                  lambda: fields.potential(cloud180, grid),
                  lambda got, want: _within(
                      _potential_err(torch.as_tensor(got, device=dev), want)),
                  ("dipole_potential",), launches, shape="180000 x 1000")
    pts, gid, G = lion_reps
    _mesh_run(mesh_label, "group_lion",
              lambda: sharding.point_group_interaction_sharded(pts, gid, G, mesh),
              lambda: fields.point_group_interaction(pts, gid, G),
              lambda got, want: (lambda eq: (eq, {"bit_equal": eq}))(
                  torch.equal(torch.as_tensor(got, device=dev), want)),
              ("dipole_group",), launches, shape=f"{len(pts)} x {G}")


def _mesh_replays(mesh, mesh_label, gt10, launches, dev) -> dict:
    """The column-sharded replay of 3 BFS orders at 10000 points, xie and
    dipole matrices (imatrix.cu's general modes), against the one-device
    replay; the loop's us a step (seconds over the 10000 steps, the matrix
    build included)."""
    from dipole_tpu_torch.ops import propagate
    from dipole_tpu_torch.parallel import sharding
    from dipole_tpu_torch.utils.io import Transform

    pts = Transform.trans(scramble(gt10, SEED + 3))[0]
    orders, _ = propagate.bfs_orders(pts, 0, times=3)
    us = {}
    for kernel in ("xie", "dipole"):
        secs = _mesh_run(
            mesh_label, f"replay_{kernel}10k_times3",
            lambda kernel=kernel: sharding.xie_in_order_sharded(pts, orders, mesh,
                                                                kernel=kernel),
            lambda kernel=kernel: propagate.xie_propagation_in_order(
                pts, orders, kernel=kernel, device=dev),
            lambda got, want: (lambda a: (a >= 0.99, {"agreement": a}))(
                float((got == want).mean())),
            (f"{kernel}_imatrix",), launches, steps=orders.shape[1])[2]
        us[kernel] = 1e6 * secs / orders.shape[1]
    return us


def phase_mesh(gt10, gt30, cloud180, hand_out, hand180, lion, launches, dev) -> dict:
    """The multi-device paths on a virtual mesh Mesh([cuda:0] * 4), and on
    make_mesh() over the cards when there are more than one: the sharded
    kernels (_mesh_kernels), the sharded replays, orient_simple on the 10k
    ellipsoid (equal to the one-device run, GT >= 0.99, the sharded
    greedy's us a step), orient(method="tree_xie", times=3) at 30000
    (agreement >= 0.99 with one device, GT >= 0.95), orient_large on the
    180k lion at the lion demo's flags (GT >= 0.95, agreement reported), and
    the handlers under set_mesh (simple_estimate equal to the one-device
    reply, GT >= 0.99; tree_xie GT >= 0.95)."""
    from dipole_tpu_torch import api
    from dipole_tpu_torch.api import MAX_PATCH_SIZE
    from dipole_tpu_torch.ops.patching import divide_pc
    from dipole_tpu_torch.parallel import sharding
    from dipole_tpu_torch.serve import handlers
    from dipole_tpu_torch.utils.io import Transform
    from dipole_tpu_torch.utils.timing import timer_factory

    t_phase = time.perf_counter()
    pc = Transform.trans(lion)[0]
    patches = divide_pc(pc[:, :3], LION_FLAGS["number_parts"],
                        min_patch=LION_FLAGS["minimum_points_per_patch"])
    rng = np.random.default_rng(1)
    reps = [p[rng.permutation(len(p))][:MAX_PATCH_SIZE] for p in patches]
    lion_reps = (torch.as_tensor(pc[np.concatenate(reps)], device=dev),
                 torch.as_tensor(np.concatenate([np.full(len(r), i)
                                                 for i, r in enumerate(reps)]),
                                 device=dev), len(reps))
    meshes = [(f"virtual{MESH_SHARDS}", sharding.Mesh([torch.device("cuda", 0)] * MESH_SHARDS))]
    if torch.cuda.device_count() > 1:
        m = sharding.make_mesh()
        meshes.append((f"cards{m.size}", m))
    res = {}
    for mesh_label, mesh in meshes:
        _mesh_kernels(mesh, mesh_label, hand_out, hand180, cloud180, lion_reps,
                      launches, dev)
        res[f"{mesh_label}_replay_us_per_step"] = _mesh_replays(mesh, mesh_label,
                                                                gt10, launches, dev)

    mesh_label, mesh = meshes[0]

    # orient_simple: the sharded greedy and sign fix
    inp = scramble(gt10, SEED + 1)
    timer = timer_factory()
    _mesh_run(
        mesh_label, "orient_simple_10k_6col_diffuse",
        lambda: api.orient_simple(inp, diffuse=True, mesh=mesh, timer=timer,
                                  device="cuda"),
        lambda: api.orient_simple(inp, diffuse=True, device="cuda"),
        _oriented(gt10, 0.99, equal=True), ("dipole_potential",), launches)
    greedy_s = timer.stages.get("dipole propagation (multichip)")
    res["greedy_us_per_step"] = (None if greedy_s is None
                                 else 1e6 * float(greedy_s) / (len(inp) - 1))

    # tree_xie at the server's cap: the column-sharded replay, its loop
    # timed where propagate calls it
    inp30 = scramble(gt30, SEED + 30000)[:, :3].copy()
    replays, real = [], sharding.xie_in_order_sharded

    def timed_replay(pts, orders, *args, **kw):
        secs, out = _synced(lambda: real(pts, orders, *args, **kw))
        replays.append((secs, np.shape(orders)[1]))
        return out

    sharding.xie_in_order_sharded = timed_replay
    try:
        _mesh_run(
            mesh_label, "tree_xie30k_times3",
            lambda: api.orient(inp30, method="tree_xie", times=3, mesh=mesh,
                               device="cuda"),
            lambda: api.orient(inp30, method="tree_xie", times=3, device="cuda"),
            _oriented(gt30, 0.95, agree=0.99), ("xie_imatrix", "dipole_potential"),
            launches)
    finally:
        sharding.xie_in_order_sharded = real
    require(len(replays) == 1, f"tree_xie under a mesh ran {len(replays)} sharded replays")
    res["tree_xie30k_replay_us_per_step"] = 1e6 * replays[0][0] / replays[0][1]

    # orient_large on the lion: the sharded ensemble, patch propagation,
    # rest-point re-vote and sign fix
    models = [str(m) for m in MODELS]
    inp_lion = scramble(lion, SEED + 5)
    _mesh_run(
        mesh_label, "lion180k_orient_large",
        lambda: api.orient_large(inp_lion, models=models, mesh=mesh, device="cuda",
                                 **LION_FLAGS),
        lambda: api.orient_large(inp_lion, models=models, device="cuda", **LION_FLAGS),
        _oriented(lion, 0.95), ("knn", "fps", "dipole_group", "dipole_field",
                                "dipole_potential"), launches)

    # the handlers under the server-wide mesh (the micro-batcher bypassed)
    xyz = scramble(gt10, SEED + 7)[:, :3].astype(np.float64)
    cfg = dict(SERVE_XIE)
    try:
        def meshed(name, config):
            handlers.set_mesh(mesh)
            try:
                return handlers.dispatch(name, xyz, config, device="cuda")
            finally:
                handlers.set_mesh(None)

        _mesh_run(
            mesh_label, "handler_simple_estimate10k",
            lambda: meshed("simple_estimate", {}),
            lambda: handlers.dispatch("simple_estimate", xyz, {}, device="cuda"),
            _oriented(gt10, 0.99, equal=True), ("dipole_potential",), launches)
        _mesh_run(
            mesh_label, "handler_tree_xie10k",
            lambda: meshed("tree_xie_propagation", cfg),
            lambda: handlers.dispatch("tree_xie_propagation", xyz, cfg, device="cuda"),
            _oriented(gt10, 0.95), ("xie_imatrix", "dipole_potential"), launches)
    finally:
        handlers.set_mesh(None)
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "mesh", "summary": res, "card": CARD.get("nvidia_smi")})
    return res


MESH_TRAIN_SHAPES = ((2, 2), (4, 1))   # the train_mesh phase's virtual meshes


def _train_corpus(hand10: np.ndarray, dev) -> list:
    """The train phase's corpus, in train_on_clouds' order: the 10k hand's
    patches (patches_from_cloud of the hand written as a .xyz), then the 199
    mined states."""
    import tempfile

    from dipole_tpu_torch import train
    from dipole_tpu_torch.utils.io import export_pc

    with tempfile.TemporaryDirectory() as tmp:
        hand = Path(tmp) / "hand10k.xyz"
        export_pc(hand10, hand)
        return train.patches_from_cloud(hand, device=dev) + _mined_states()


def _train_run(corpus, steps: int, mesh, dev, timer=None):
    """train_on_clouds recipe A at the train phase's 16 x 512, pool 0.6, lr
    1e-3 and seed, `steps` steps on `corpus`, under `mesh` (1: one device,
    where None would take every card): (the whole model, whose .grad is the
    last step's gradient, history)."""
    from dipole_tpu_torch import train

    model, history, _ = train.train_on_clouds(
        [], extra_data=corpus, verbose=False, device=dev, mesh=mesh, timer=timer,
        **dict(TRAIN_KW, steps=steps), **TRAIN_RECIPE_A)
    return model, history


def _launch_step_timer():
    """_step_split_timer's synchronized parts, and each step's kNN and FPS
    launches (counted from the step's forward to its optimizer's end) in
    `timer.launches`."""
    import contextlib

    split = _step_split_timer()
    marks = []

    @contextlib.contextmanager
    def timer(label):
        if label == "forward":
            marks.append(dict(_read_counts()[0]))
        with split(label):
            yield
        if label == "optimizer":
            now = _read_counts()[0]
            marks[-1] = {k: now[k] - marks[-1][k] for k in ("knn", "fps")}

    timer.parts, timer.launches = split.parts, marks
    return timer


def _step_ms(parts: dict) -> list:
    """Each step's synchronized ms, the sum of its parts."""
    return [1e3 * sum(v) for v in zip(*parts.values())]


def _grad_rel_diff(got, want) -> float:
    """The largest |g - g_want| of any parameter over its max |g_want|, or
    inf where the two models have gradients for different parameters."""
    got = {k: p.grad for k, p in got.named_parameters() if p.grad is not None}
    want = {k: p.grad for k, p in want.named_parameters() if p.grad is not None}
    if got.keys() != want.keys():
        return float("inf")
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def _plain_loss_step(mesh, dev) -> dict:
    """One step of the non-gauge-free loss (sum(nll w) / sum(w) over the
    whole batch) under `mesh` against one device, on the fixed 16 x 512
    make_batch with patch b's valid points cut to 512 - 12 b (332 at the
    least, above the 307 FPS points), so that the data rows' valid counts
    differ: the loss within 1e-5 relative, each gradient within 1e-4 of its
    max |g|. The mean of the rows' own losses is reported beside it, and
    must miss the global loss by more than the loss tolerance, so that the
    check tells the two apart."""
    from dipole_tpu_torch import train
    from dipole_tpu_torch.models.pointcnn import _pad_sizes, key_starts
    from dipole_tpu_torch.utils import prng

    n, pool, batch = TRAIN_KW["bucket"], TRAIN_KW["pool"], TRAIN_KW["batch"]
    pc, labels, valid = train.make_batch(prng.prng_key(1), batch, n)
    for b in range(batch):
        valid[b, n - 12 * b:] = False
        pc[b, n - 12 * b:] = 0
        labels[b, n - 12 * b:] = 0
    starts = key_starts(prng.prng_key(2), valid.sum(1), pool, _pad_sizes(n, pool)[0])
    out = {}
    for run, m in (("one", None), ("mesh", mesh)):
        model = train._fresh_model(prng.prng_key(0), train._probe_patch(0, n), pool, dev)
        _opt, step = train.make_train_step(model, 1e-3, total_steps=20, mesh=m)
        out[run] = (float(step(pc, labels, valid, starts)[0]), step.gather())
    (loss1, one), (loss, got) = out["one"], out["mesh"]
    rows, b = mesh.shape["data"], batch // mesh.shape["data"]
    with torch.no_grad():
        row_means = [float(train.loss_fn(
            one, *(torch.as_tensor(x[r * b:(r + 1) * b], device=dev)
                   for x in (pc, labels, valid)), starts[r * b:(r + 1) * b])[0])
            for r in range(rows)]
    line = {"loss": loss, "loss_one_device": loss1,
            "loss_rel_diff": abs(loss - loss1) / abs(loss1),
            "grad_max_rel_diff": _grad_rel_diff(got, one),
            "valid_per_row": [int(valid[r * b:(r + 1) * b].sum()) for r in range(rows)],
            "mean_of_row_means_rel_diff": float(abs(np.mean(row_means) - loss1) / abs(loss1))}
    require(line["mean_of_row_means_rel_diff"] > 1e-5,
            f"plain-loss step: the rows' mean {row_means} does not tell apart "
            f"from the global loss {loss1}")
    require(line["loss_rel_diff"] <= 1e-5,
            f"plain-loss step: loss off by {line['loss_rel_diff']}")
    require(line["grad_max_rel_diff"] <= 1e-4,
            f"plain-loss step: gradients off by {line['grad_max_rel_diff']} of max |g|")
    return line


def phase_train_mesh(hand10: np.ndarray, launches, dev) -> dict:
    """Training under a mesh on the card: train_on_clouds recipe A at the
    train phase's 16 x 512 on its corpus, on the virtual meshes
    Mesh([cuda:0] * 4, shape=(2, 2)) and (4, 1), and on make_mesh over the
    cards (data axis the largest divisor of the batch) where there are
    several. One step on each from the one-device run's seed: the loss
    within 1e-5 relative of the one-device step, each gradient summed over
    the data rows within 1e-4 of its max |g| (tests/test_torch_train.py's
    tolerances). Recipe A is gauge-free with equal patch counts a row, so
    one step of the non-gauge-free loss with valid counts that differ
    between the rows follows on (2, 2) (_plain_loss_step). Then 10 steps on one device and on (2, 2), each step
    synchronized part by part: ms a step (median of steps 3-9) side by side,
    kNN and FPS launches a step (the mesh's: the one-device count times the
    data rows), no plain call, counts reset just before the mesh run and read
    just after. Then the fixed 16 x 512 batch trained 60 steps at lr 3e-3 on
    (2, 2) past the train phase's bar, and the (2, 2)-trained model through
    save_state_dict -> PointCNN.from_files with bit-equal logits."""
    from dipole_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    corpus = _train_corpus(hand10, dev)
    batch = TRAIN_KW["batch"]
    meshes = [(f"virtual{MESH_SHARDS}_{d}x{m}",
               sharding.Mesh([torch.device("cuda", 0)] * MESH_SHARDS, shape=(d, m)))
              for d, m in MESH_TRAIN_SHAPES]
    if torch.cuda.device_count() > 1:
        d = torch.cuda.device_count()
        while batch % d:
            d -= 1
        meshes.append((f"cards{d}x1", sharding.make_mesh(d, shape=(d, 1))))
    res = {"card": CARD.get("nvidia_smi"), "batch": batch, "bucket": TRAIN_KW["bucket"],
           "recipe": TRAIN_RECIPE_A, "note": MESH_NOTE}
    one, hist1 = _train_run(corpus, 1, 1, dev)
    loss1 = hist1[0][0]
    for label, mesh in meshes:
        model, hist = _train_run(corpus, 1, mesh, dev)
        loss_rel = abs(hist[0][0] - loss1) / abs(loss1)
        grad_rel = _grad_rel_diff(model, one)
        line = {"loss": hist[0][0], "loss_one_device": loss1, "loss_rel_diff": loss_rel,
                "grad_max_rel_diff": grad_rel, "shape": mesh.shape}
        res[f"{label}_one_step"] = line
        emit({"phase": "train_mesh", "mesh": label, "run": "one_step", **line,
              "rtol_loss": 1e-5, "rtol_grad_of_max": 1e-4, "card": CARD.get("nvidia_smi")})
        require(loss_rel <= 1e-5, f"train_mesh {label}: loss off by {loss_rel}")
        require(grad_rel <= 1e-4, f"train_mesh {label}: gradients off by {grad_rel} of max |g|")

    label, mesh = meshes[0]
    res["plain_loss_one_step"] = _plain_loss_step(mesh, dev)
    emit({"phase": "train_mesh", "mesh": label, "run": "plain_loss_one_step",
          **res["plain_loss_one_step"], "card": CARD.get("nvidia_smi")})
    rows = mesh.shape["data"]
    timers = {}
    for run, m in (("one_device", 1), (label, mesh)):
        timers[run] = _launch_step_timer()
        torch.cuda.synchronize()
        _reset_counts()
        model, hist = _train_run(corpus, 10, m, dev, timers[run])
        torch.cuda.synchronize()
        counts, plain = _read_counts()
        require(np.isfinite([h[0] for h in hist]).all(), f"train_mesh {run}: loss {hist}")
    run = f"train_mesh_{label}_10_steps"
    RUN_COUNTS[run] = counts
    for name in ("knn", "fps"):
        require(counts[name] > 0, f"{run}: kernel {name} not launched")
        launches[name] = launches.get(name, 0) + counts[name]
    require(not any(plain.values()), f"{run}: plain version called on CUDA: {plain}")
    per_one, per_mesh = timers["one_device"].launches, timers[label].launches
    require(all(m == {k: rows * v for k, v in o.items()} for o, m in zip(per_one, per_mesh)),
            f"{run}: launches a step {per_mesh} against one device's {per_one} x {rows}")
    ms_one, ms_mesh = (_step_ms(timers[r].parts) for r in ("one_device", label))
    res["ten_steps"] = {
        "step_ms_median_steps_3_9": float(np.median(ms_mesh[3:10])),
        "one_device_step_ms_median_steps_3_9": float(np.median(ms_one[3:10])),
        "parts_ms_median_steps_3_9": {k: 1e3 * float(np.median(v[3:10]))
                                      for k, v in timers[label].parts.items()},
        "one_device_parts_ms_median_steps_3_9": {
            k: 1e3 * float(np.median(v[3:10])) for k, v in timers["one_device"].parts.items()},
        "launches_per_step": per_mesh[-1], "one_device_launches_per_step": per_one[-1],
        "launches": {k: v for k, v in counts.items() if v}, "plain_cuda_calls": plain,
        "history": hist}
    emit({"phase": "train_mesh", "mesh": label, "run": "ten_steps", **res["ten_steps"],
          "card": CARD.get("nvidia_smi")})
    res["fixed_batch"] = _fixed_batch(dev, mesh)
    res["reload"] = _reload_logits(model, corpus, dev)
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train_mesh", "summary": {k: v for k, v in res.items() if k != "ten_steps"}})
    return res


def _lattice_check(pc: torch.Tensor, res: int, quantity: str, dev) -> float:
    """The vis lattice of `quantity` from its kernel against the plain
    version on the card: the tolerance ratio (<= 1 passes)."""
    from dipole_tpu_torch.ops import fields

    lin = np.linspace(-1.2, 1.2, res)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = torch.as_tensor(np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
                           .astype(np.float32), device=dev)
    if quantity == "potential":
        return _potential_err(fields.potential(pc, grid),
                              fields.potential_plain(pc, grid))
    return _field_ratio(fields.field_grad(pc, grid).cpu().numpy(),
                        fields.field_grad_plain(pc, grid, 1e-5))


def phase_vis(hand10: np.ndarray, hand_out: np.ndarray, launches, dev) -> dict:
    """vis.py and analysis.py on the card: draw_field_isosurface on the 10k
    hand at res 48 (110592 lattice targets: potential.cu, then |E| by
    field.cu), plot_cross_section (the .ply export where matplotlib is
    missing), and analysis.self_interaction_table over segments written from
    the oriented hand's patches in get_segs's layout (res<i>.ply and
    reslog.json); each lattice held to its plain version on the card, the
    table to the CPU's."""
    import tempfile

    from dipole_tpu_torch import analysis, vis
    from dipole_tpu_torch.ops.metrics import sign_agreement
    from dipole_tpu_torch.ops.patching import divide_pc
    from dipole_tpu_torch.utils.io import write_ply

    t_phase = time.perf_counter()
    pc = torch.as_tensor(hand10, device=dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for quantity, kernel in (("potential", "dipole_potential"),
                                 ("field", "dipole_field")):
            label = f"vis_isosurface_{quantity}_res48"
            verts, faces, _ = _kernel_run(
                label, lambda t, q=quantity: vis.draw_field_isosurface(
                    hand10, tmp / f"iso_{q}.ply", res=48, quantity=q, device="cuda"),
                (kernel,), launches,
                lambda out: {"vertices": len(out[0]), "faces": len(out[1])})
            ratio = _lattice_check(pc, 48, quantity, dev)
            res[label] = {"tolerance_ratio": ratio, "vertices": len(verts),
                          "launches": RUN_COUNTS[label][kernel]}
            emit({"phase": "vis", "run": label, "lattice_targets": 48 ** 3,
                  "tolerance_ratio": ratio, "card": CARD.get("nvidia_smi")})
            require(len(faces) > 0 and (tmp / f"iso_{quantity}.ply").stat().st_size > 200,
                    f"{label}: no surface written")
            require(ratio <= 1.0, f"{label}: lattice off its plain version by {ratio}")
        written = _kernel_run("vis_cross_section", lambda t: vis.plot_cross_section(
            hand10, tmp / "slice.png", device="cuda"), ("dipole_potential",), launches,
            lambda out: {"written": Path(out).name})
        try:
            import matplotlib  # noqa: F401
            want_suffix = ".png"
        except ImportError:
            want_suffix = ".ply"
        require(Path(written).suffix == want_suffix and Path(written).exists(),
                f"plot_cross_section wrote {written}, expected a {want_suffix}")
        res["cross_section"] = Path(written).name

        # get_segs's layout from the oriented hand's patches
        patches = [p for p in divide_pc(hand_out[:, :3], 30, min_patch=100)][:8]
        log = []
        for i, p in enumerate(patches):
            write_ply(tmp / f"res{i}.ply", hand_out[p, :3], hand_out[p, 3:6])
            log.append({"id": i, "metric": sign_agreement(hand_out[p], hand10[p])})
        (tmp / "reslog.json").write_text(json.dumps({"node_log": log}))
        segs = analysis.get_segs(tmp)
        table = _kernel_run("analysis_self_interaction", lambda t: analysis.
                            self_interaction_table(segs, device="cuda"),
                            ("dipole_field",), launches,
                            lambda out: {"segments": len(out)})
        want = analysis.self_interaction_table(segs, device="cpu")
        # the same random splits (the table's default rng); each value within
        # 1e-3 of the row's largest |value| (sums of E.n that may cancel)
        keys = ("self_interaction", "self_interaction_all", "random_self_interaction")
        worst = 0.0
        for got_row, want_row in zip(table, want):
            scale = 1e-3 * max(abs(want_row[k]) for k in keys) + 1e-12
            worst = max(worst, max(abs(got_row[k] - want_row[k]) / scale for k in keys))
        res["analysis"] = {"segments": len(table), "tolerance_ratio_vs_cpu": worst}
        emit({"phase": "vis", "run": "analysis_self_interaction", "segments": len(table),
              "tolerance_ratio_vs_cpu": worst, "rtol": 1e-3})
        require(len(table) == len(patches) and worst <= 1.0,
                f"self_interaction_table: {len(table)} rows, off the CPU's by {worst}")
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "vis", "summary": res, "card": CARD.get("nvidia_smi")})
    return res


def main(argv) -> int:
    checks_only = "--checks-only" in argv
    info = phase_device()
    import dipole_tpu_torch  # noqa: F401  (sets TF32 off)

    phase_build()
    dev = torch.device("cuda")
    gt10 = ellipsoid(10000, SEED)
    gt180 = ellipsoid(180000, SEED + 180)
    from dipole_tpu_torch.utils.io import Transform

    cloud180 = torch.as_tensor(Transform.trans(gt180)[0], device=dev)
    errs = phase_checks(cloud180, gt10)
    errs.update(phase_checks_patch(dev))
    errs.update(phase_checks_xie(gt10, dev))
    errs.update(phase_checks_radius(gt10, gt180, dev))
    mxu_errs, mxu_plain_ms = phase_checks_mxu(dev)
    errs.update(mxu_errs)
    if checks_only:
        emit({"phase": "done", "checks_only": True})
        return 0
    launches = phase_main_path(gt10, gt180)
    t0 = time.perf_counter()
    hand10 = metaball_cloud(10000, HAND_BALLS, 1.6, SEED + 10)
    hand180 = metaball_cloud(180000, HAND_BALLS, 1.6, SEED + 11)
    lion = metaball_cloud(180000, LION_BALLS, 1.35, SEED + 12)
    emit({"phase": "shapes", "seconds": time.perf_counter() - t0})
    hand_out = phase_main_path_patches(hand10, hand180, lion, launches)
    gt30 = ellipsoid(30000, SEED + 30)
    phase_main_path_xie(gt10, gt30, launches)
    phase_serve(launches)
    trained = phase_train(hand10, launches, dev)
    phase_torch_rng(hand10, launches, dev)
    tool = phase_main_path_mxu(launches)
    timing = phase_timing(gt10, gt180, dev)
    timing["radius_knn"] = time_radius_knn(gt10, gt180, dev)
    timing.update(phase_timing_patches(hand_out, hand180, lion, dev))
    timing.update(phase_timing_xie(gt10, gt30, dev))
    timing.update(phase_timing_mxu(tool, mxu_plain_ms, dev))
    timing.update(phase_timing_serve(
        dev, timing["greedy_columns"]["full_grid_us_per_step"]["a_us"]))
    # after every profiled timing: see the docstring's phase 6
    time_plain_greedy_columns(gt180, timing, dev)
    phase_mesh(gt10, gt30, cloud180, hand_out, hand180, lion, launches, dev)
    trained_mesh = phase_train_mesh(hand10, launches, dev)
    phase_vis(hand10, hand_out, launches, dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timing[name]
        per_step = trained["split"]["launches_per_step"]
        per_mesh_step = trained_mesh["ten_steps"]["launches_per_step"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **({"launches_per_train_step": per_step[name],
                            "launches_per_mesh_train_step": per_mesh_step[name]}
                           if name in per_step else {}),
                        "max_abs_err": max(errs[name], t.get("max_abs_err", 0.0)),
                        "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms"),
                        "library_call": LIBRARY_CALLS.get(name),
                        "shape": t["shape"],
                        **{k: t[k] for k in ("fit_us_per_step", "full_grid_us_per_step",
                                             "step_floor_ms", "step_floor_132_blocks_ms",
                                             "single_launches_ms")
                           if k in t}})
    emit({"kernels": kernels})
    print(info["nvidia_smi"].splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
