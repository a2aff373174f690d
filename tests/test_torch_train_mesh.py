"""Training under a mesh in the port (dipole_tpu_torch.train with mesh=) on
CPU shards, against the port on one device and against dipole_tpu.train on
the conftest's 8 virtual JAX CPU devices. One JAX mesh run is compiled, at
(2, 2), module-scoped: the JAX history does not depend on the mesh's shape.

Tolerances: one step's loss within 1e-5 relative of the one-device step and
each gradient within 1e-4 of its max |g| (tests/test_torch_train.py's:
float32 sums in other orders, per data row and per model piece; seen: 1.2e-7
and 1e-6); histories within 1e-3 relative (seen: 1.6e-5 against JAX).
Parameters after two steps against JAX's: 99 % of the entries within
0.05 lr and every entry within 2 lr (seen: 0.02 lr and 0.97 lr, the same as
the one-device port's): Adam's first steps move an entry by about
lr g / (|g| + eps), so an entry whose gradient is near eps = 1e-8 follows
the last bits of its gradient, and may step the other way.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from dipole_tpu import train as jtrain
from dipole_tpu.models import checkpoints as jcheckpoints
from dipole_tpu_torch import train
from dipole_tpu_torch.models import checkpoints, pointcnn
from dipole_tpu_torch.parallel import sharding
from dipole_tpu_torch.utils import prng
from tests.test_torch_train import _mined

CPU = torch.device("cpu")
NB, POOL, B = 64, 0.6, 4
M1 = int(-(-NB * POOL // 1))
LR = 1e-3


def _mesh(shape):
    return sharding.make_mesh(device="cpu", shape=shape)


@pytest.fixture(scope="module")
def jax_run():
    """dipole_tpu.train under a (2, 2) mesh: (params, history)."""
    devs = np.array(jax.devices()[:4])
    return jtrain.train(steps=2, batch=B, n_points=NB, verbose=False,
                        mesh=JMesh(devs.reshape(2, 2), ("data", "model")))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_param_sharding_matches_jax(m):
    """The same leaves split into the same number of pieces as the JAX
    NamedShardings' specs; a model axis of 3 divides no leaf."""
    params = train.init_params(prng.prng_key(0))
    want = jtrain.param_sharding(
        JMesh(np.array(jax.devices()[:m]).reshape(1, m), ("data", "model")), params)
    got = train.param_sharding(_mesh((1, m)), params)
    assert set(got) == set(want)
    for k, sh in want.items():
        spec = tuple(sh.spec)
        assert got[k] == (m if spec and spec[0] == "model" else 1), k
    assert sum(v > 1 for v in got.values()) == (28 if m in (2, 4) else 0)
    assert train.param_sharding(None, params) == {k: 1 for k in params}
    assert train.param_sharding(_mesh((m,)), params) == {k: 1 for k in params}


@pytest.fixture(scope="module")
def step_case():
    """Calibrated parameters and a batch of 4 whose valid counts differ in
    every row (64, 50, 40, 64 of 64)."""
    params = train.calibrate_init(train.init_params(prng.prng_key(0)),
                                  train._probe_patch(0, NB), POOL, device="cpu")
    pc, labels, valid = train.make_batch(prng.prng_key(4), B, NB)
    for b, n in ((1, 50), (2, 40)):
        valid[b, n:] = False
        pc[b, n:] = 0
        labels[b, n:] = 0
    starts = pointcnn.key_starts(prng.prng_key(9), valid.sum(1), POOL, M1)
    return params, (pc, labels, valid, starts)


def _one_step(params, batch, mesh, **kw):
    model = pointcnn.from_numpy_params(params, POOL, trainable=True)
    _opt, step = train.make_train_step(model, LR, total_steps=20, mesh=mesh, **kw)
    loss, acc = step(*batch)
    return float(loss), float(acc), step.gather(), step


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("kw", [{}, dict(class_balance=True, gauge_free=True)],
                         ids=["plain", "balanced_gauge_free"])
def test_step_matches_one_device(step_case, shape, kw):
    """The global loss and acc, and every gradient summed over the data
    rows, equal the one-device step's; leaves the forward never reads
    (mlp1) have no gradient on either."""
    params, batch = step_case
    l1, a1, whole, _ = _one_step(params, batch, None, **kw)
    want = {k: p.grad for k, p in whole.named_parameters()}
    lm, am, got, step = _one_step(params, batch, _mesh(shape), **kw)
    assert len(step.replicas) == shape[0]
    assert abs(lm - l1) <= 1e-5 * abs(l1)
    assert am == pytest.approx(a1, abs=1e-6)
    for k, p in got.named_parameters():
        if want[k] is None:
            assert p.grad is None and ".mlp1." in k, k
            continue
        scale = float(want[k].abs().max())
        assert float((p.grad - want[k]).abs().max()) <= 1e-4 * scale, k


def test_train_history_and_params_match_jax_mesh(jax_run):
    jparams, jhist = jax_run
    model, hist = train.train(steps=2, batch=B, n_points=NB, verbose=False,
                              device="cpu", mesh=_mesh((2, 2)))
    np.testing.assert_allclose(np.asarray(hist), np.asarray(jhist), rtol=1e-3)
    diff = np.concatenate([np.abs(v.numpy() - np.asarray(jparams[k])).ravel()
                           for k, v in model.state_dict().items()])
    assert np.quantile(diff, 0.99) <= 0.05 * LR
    assert diff.max() <= 2 * LR


def test_train_on_clouds_mesh_matches_one_device():
    """extra_data only, the fixers' recipe A at batch 4, bucket 128: the
    (2, 2) mesh's history equals the one-device run's; snapshots on the
    schedule."""
    kw = dict(steps=2, batch=4, bucket=128, verbose=False, region_flip=0.9,
              region_draws=2, point_flip=0.4, class_balance=True,
              gauge_free=True, extra_data=_mined(6), device="cpu")
    snaps = []
    _, one, _ = train.train_on_clouds([], **kw)
    model, got, _ = train.train_on_clouds(
        [], mesh=_mesh((2, 2)), snapshot_every=1,
        snapshot_fn=lambda s, m: snaps.append((s, m)), **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(one), rtol=1e-3)
    assert [s for s, _ in snaps] == [1, 2] and snaps[-1][1] is model


def test_gathered_model_is_whole_and_reloads(step_case, tmp_path):
    """After two steps under (2, 2): every row's replica holds the masters'
    values, the gathered model is the masters' pieces concatenated, in the
    checkpoint layout of init_params; its save_state_dict file loads in the
    JAX package's reader and, through PointCNN.from_files, gives the same
    logits."""
    params, batch = step_case
    _, _, _, step = _one_step(params, batch, _mesh((2, 2)))
    step(*batch)
    model = step.gather()
    rows = [dict(r.named_parameters()) for r in step.replicas]
    for row in rows[1:]:
        assert row.keys() == rows[0].keys()
        for k, v in row.items():
            assert torch.equal(v, rows[0][k]), k
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in train.init_params(prng.prng_key(0)).items()}
    split = train.param_sharding(_mesh((2, 2)), state)
    for k, v in state.items():
        pieces = [rows[0][k]] if split[k] == 1 else [rows[0][f"{k}.{j}"] for j in (0, 1)]
        assert torch.equal(v, torch.cat(pieces)), k
    path = tmp_path / "mesh.pt"
    checkpoints.save_state_dict(state, path)
    path.with_suffix(".txt").write_text(f"pool: {POOL}\n")
    back = jcheckpoints.load_state_dict(path)
    assert list(back) == list(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v.numpy())
    reloaded = pointcnn.PointCNN.from_files(path)
    assert reloaded.content_digest == model.content_digest
    patch = batch[0][1, :50]
    np.testing.assert_array_equal(pointcnn.pointcnn_logits(reloaded, patch),
                                  pointcnn.pointcnn_logits(model, patch))


def test_mesh_refusals_and_defaults(step_case):
    """A data axis that does not divide the batch raises ValueError, in
    train and in a step; a CPU mesh under device="cuda" raises; a count N
    is (N, 1); mesh=None on the CPU is one device."""
    params, batch = step_case
    with pytest.raises(ValueError, match="does not divide"):
        train.train(steps=1, batch=3, n_points=NB, device="cpu", verbose=False,
                    mesh=_mesh((2, 1)))
    with pytest.raises(ValueError, match="does not divide"):
        _one_step(params, [x[:3] for x in batch], _mesh((2, 2)))
    with pytest.raises(ValueError, match="does not run"):
        train._train_mesh(_mesh((2, 2)), torch.device("cuda"), 4)
    with pytest.raises((ValueError, RuntimeError)):
        train.train(steps=1, batch=4, n_points=NB, device="cuda", verbose=False,
                    mesh=_mesh((2, 2)))
    assert train._train_mesh(2, CPU, 4).shape == {"data": 2, "model": 1}
    assert train._train_mesh(_mesh((4,)), CPU, 4).shape == {"data": 4, "model": 1}
    assert train._train_mesh(None, CPU, 4) is None
    assert train._train_mesh(1, CPU, 4) is None
    model, hist = train.train(steps=1, batch=2, n_points=NB, device="cpu",
                              verbose=False)
    assert np.isfinite(hist).all() and next(model.parameters()).device == CPU
