"""The port's training (dipole_tpu_torch.train) against dipole_tpu.train on
JAX-CPU: initial parameters, batches, the loss and its gradients, the
optimizer against optax, and a short run of train_on_clouds.

Tolerances: the loss to 1e-5 relative and each gradient tensor to 1e-4 of
its max |g| (float32 sums in other orders through seven XConv stages; seen:
3.4e-7 and 7.7e-6); optimizer parameters to 1e-6 relative; histories to
1e-3. The JAX jits are module-scoped fixtures and no JAX loop runs more than
3 steps."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dipole_tpu import train as jtrain
from dipole_tpu_torch import train
from dipole_tpu_torch.models import pointcnn
from dipole_tpu_torch.utils import prng

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_params_match_jax(seed):
    """Same keys, shapes and draws: within 1 ulp of each tensor's range
    (the JAX CPU backend's FMA in uniform; tests/test_torch_prng.py)."""
    want = jtrain.init_params(jax.random.PRNGKey(seed))
    got = train.init_params(prng.prng_key(seed))
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=np.spacing(np.float32(np.abs(v).max())))


@pytest.mark.parametrize("seed,batch,n", [(1, 3, 64), (5, 2, 128), (9, 1, 33)])
def test_make_batch_equal(seed, batch, n):
    got = train.make_batch(prng.prng_key(seed), batch, n)
    want = jtrain.make_batch(jax.random.PRNGKey(seed), batch, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


B, NB, POOL = 2, 128, 0.6
M1 = int(-(-NB * POOL // 1))
M2 = int(-(-M1 * POOL // 1))


@pytest.fixture(scope="module")
def case():
    """Calibrated parameters (numpy, shared by both packages), one full
    patch and one with 100 valid rows of 128, and the step's FPS key."""
    p0 = {k: np.asarray(v) for k, v in jtrain.init_params(jax.random.PRNGKey(0)).items()}
    params = train.calibrate_init(p0, train._probe_patch(0, NB), POOL, device="cpu")
    pc, labels, valid = train.make_batch(prng.prng_key(4), B, NB)
    valid[1, 100:] = False
    pc[1, 100:] = 0
    labels[1, 100:] = 0
    return params, pc, labels, valid, prng.prng_key(9)


@pytest.fixture(scope="module")
def jax_loss_grad():
    return jax.value_and_grad(jtrain.loss_fn, has_aux=True)


@pytest.mark.parametrize("class_balance,gauge_free,keep_bias", [
    (False, False, 0.5), (True, False, 0.5), (False, True, 0.5), (True, True, 0.5),
    (True, True, 0.7)])
def test_loss_and_gradients_match_jax(case, jax_loss_grad, class_balance,
                                      gauge_free, keep_bias):
    params, pc, labels, valid, fk = case
    (jl, ja), jg = jax_loss_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pc),
        jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(prng.split(fk, B)),
        jnp.float32(POOL), M1, M2, class_balance, gauge_free, keep_bias)
    model = pointcnn.from_numpy_params(params, POOL, trainable=True)
    loss, acc = train.loss_fn(
        model, torch.as_tensor(pc), torch.as_tensor(labels), torch.as_tensor(valid),
        pointcnn.key_starts(fk, valid.sum(1), POOL, M1), class_balance,
        gauge_free, keep_bias)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(acc) == pytest.approx(float(ja), abs=1e-6)
    for k, p in model.named_parameters():
        want = np.asarray(jg[k])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, k


def test_gradients_finite_with_sentinel_neighbours():
    """n = 489 in bucket 512: 23 padded rows at stage 1 and 14 < K = 20 at
    stage 2, so sentinel rows take valid points as neighbours at ~1e6; the
    clamp keeps every gradient finite (JAX tests/test_models.py:148-175,
    built here from _probe_patch)."""
    params = train.calibrate_init(train.init_params(prng.prng_key(0)),
                                  train._probe_patch(0, 512), device="cpu")
    model = pointcnn.from_numpy_params(params, POOL, trainable=True)
    r = np.random.default_rng(5)
    n = 489
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pc = np.zeros((1, 512, 6), np.float32)
    pc[0, :n] = np.concatenate([v * [1.0, 1.0, 0.2], v], 1)
    valid = np.zeros((1, 512), bool)
    valid[0, :n] = True
    m1 = int(-(-512 * POOL // 1))
    loss, _ = train.loss_fn(model, torch.as_tensor(pc),
                            torch.ones((1, 512), dtype=torch.int64),
                            torch.as_tensor(valid),
                            pointcnn.key_starts(prng.prng_key(1), [n], POOL, m1))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    for k, p in model.named_parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), k


def test_optimizer_matches_optax():
    """Six gradient sets through optax.chain(clip_by_global_norm(1),
    adamw(warmup_cosine_decay_schedule(0, lr, 6, 60, lr * 0.05))) and
    through ClipAdamW: the first update has rate 0 (parameters unchanged),
    steps 3 and 5 have norms above 1 (the clip divides), step 4 is None for
    one tensor (zeros, only the decay moves it)."""
    r = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (5,), "c": (2, 1, 4)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr, total = 3e-3, 60
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(100, total // 10), decay_steps=total,
        end_value=lr * 0.05)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    mine = train.ClipAdamW(tp.values(), train.warmup_cosine_schedule(lr, total))
    norms = []
    for i in range(6):
        g = {k: (r.normal(size=s) * (3.0 if i in (2, 4) else 0.05)).astype(np.float32)
             for k, s in shapes.items()}
        if i == 3:
            g["c"][:] = 0
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for v in g.values()))))
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = None if (i == 3 and k == "c") else torch.tensor(g[k])
        mine.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6 * np.abs(p0[k]).max())
            if i == 0:
                np.testing.assert_array_equal(tp[k].numpy(), p0[k])
    assert norms[2] > 1 and norms[4] > 1 and max(norms[:2]) < 1
    assert float(train.warmup_cosine_schedule(lr, total)(0)) == 0.0
    for count in (0, 3, 6, 7, 30, 59, 60, 80):
        assert float(train.warmup_cosine_schedule(lr, total)(count)) == \
            pytest.approx(float(sched(count)), rel=1e-6, abs=1e-12)


def _mined(count):
    z = np.load(ROOT / "train_data" / "mined_states_r4.npz")
    off = np.concatenate([[0], np.cumsum(z["lengths"])])
    return [(z["points"][a:b], z["labels"][a:b])
            for a, b in list(zip(off[:-1], off[1:]))[:count]]


def test_train_on_clouds_history_matches_jax():
    """extra_data only (six mined states), the fixers' recipe A at steps 2,
    batch 2, bucket 128: the same batches, starts and calibrated init, so
    the histories agree to 1e-3; snapshots on the schedule."""
    kw = dict(steps=2, batch=2, bucket=128, verbose=False, region_flip=0.9,
              region_draws=2, point_flip=0.4, class_balance=True,
              gauge_free=True, extra_data=_mined(6))
    _, want, _ = jtrain.train_on_clouds([], **kw)
    snaps = []
    model, got, _ = train.train_on_clouds(
        [], device="cpu", snapshot_every=1,
        snapshot_fn=lambda s, m: snaps.append((s, m.content_digest)), **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3)
    assert [s for s, _ in snaps] == [1, 2]
    assert isinstance(model, pointcnn.PointCNN)


def test_train_on_clouds_timer_wraps_each_part():
    """timer= (the pipelines' label -> context manager) is entered around
    each step's assembly, forward, backward and optimizer, in that order,
    and leaves the history as it is without it (one thread: the CPU's
    threaded index_put accumulate in the backward sums in varying order)."""
    import contextlib

    labels = []

    @contextlib.contextmanager
    def timer(label):
        labels.append(label)
        yield

    kw = dict(steps=2, batch=2, bucket=64, verbose=False, device="cpu",
              extra_data=_mined(3))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, timed, _ = train.train_on_clouds([], timer=timer, **kw)
        _, plain, _ = train.train_on_clouds([], **kw)
    finally:
        torch.set_num_threads(threads)
    assert labels == ["assembly", "forward", "backward", "optimizer"] * 2
    assert timed == plain


def test_digest_follows_the_weights():
    """content_digest is cached until the weights change: a training step
    and a load_state_dict each give a new digest, restoring the weights the
    old one."""
    model, hist = train.train(steps=1, batch=2, n_points=64, device="cpu",
                              verbose=False, learning_rate=1e-2)
    assert np.isfinite(hist[0][0])
    before = model.content_digest
    assert model.content_digest == before
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    _opt, step = train.make_train_step(model, 1e-2, total_steps=1)
    pc, labels, valid = train.make_batch(prng.prng_key(3), 2, 64)
    m1 = int(-(-64 * POOL // 1))
    step(pc, labels, valid, pointcnn.key_starts(prng.prng_key(4), [64, 64], POOL, m1))
    after = model.content_digest
    assert after != before
    model.load_state_dict(saved)
    assert model.content_digest == before

