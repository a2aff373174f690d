"""The port's PointCNN (dipole_tpu_torch.models) against dipole_tpu.models on
JAX-CPU: checkpoints, digests, logits and ensemble votes.

Both packages get the same weights (the JAX package's parameter dict through
from_numpy_params) and the same FPS starts. Logits agree to atol 1e-3 on
values up to ~15 (float32 sums in other orders, and kNN near-ties the JAX
package's FMA contraction may swap; tests/test_pallas.py:204); votes on the
fixed batch are identical."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipole_tpu.models import checkpoints as jcheckpoints
from dipole_tpu.models import inference as jinference
from dipole_tpu.models import pointcnn as jpointcnn
from dipole_tpu_torch.models import checkpoints, inference, pointcnn
from tests.conftest import make_sphere

ROOT = Path(__file__).resolve().parent.parent
CKPTS = sorted((ROOT / "pre_trained_tpu").glob("*.pt"))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX params, port module) pairs for dipole_0 and dipole_1."""
    out = []
    for name in ("dipole_0", "dipole_1"):
        j = jpointcnn.PointCNNParams.from_files(ROOT / "pre_trained_tpu" / f"{name}.pt")
        t = pointcnn.from_numpy_params({k: np.asarray(v) for k, v in j.params.items()},
                                       j.pool)
        out.append((j, t))
    return out


def _patches(seed, sizes):
    r = np.random.default_rng(seed)
    sp = make_sphere(3000, seed=seed, noise=0.01)
    out = []
    for n in sizes:
        c = sp[r.integers(len(sp)), :3]
        near = np.argsort(((sp[:, :3] - c) ** 2).sum(1))[:n]
        p = sp[near].copy()
        p[r.random(n) < 0.3, 3:] *= -1
        out.append(p)
    return out


@pytest.mark.parametrize("path", CKPTS, ids=[p.stem for p in CKPTS])
def test_checkpoint_loads_same_arrays_and_digest(path):
    got = checkpoints.load_state_dict(path)
    want = jcheckpoints.load_state_dict(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert checkpoints.load_model_opts(path.with_suffix(".txt")) == \
        jcheckpoints.load_model_opts(path.with_suffix(".txt"))
    model = pointcnn.PointCNN.from_files(path)
    assert model.content_digest == \
        jpointcnn.PointCNNParams.from_files(path).content_digest


def test_logits_match_jax_forward(models):
    j, t = models[0]
    patches = _patches(1, (100, 128, 77, 120, 90))
    nb = 128
    m1 = int(-(-nb * j.pool // 1))
    m2 = int(-(-m1 * j.pool // 1))
    pc, valid, _, lens = jpointcnn.prepare_patch_batches(patches, nb, 8)[0]
    st = pointcnn.key_starts(np.asarray(jax.random.PRNGKey(3)), lens, j.pool, m1)
    pad = np.zeros((8, 2), np.int32)
    pad[:len(st)] = st
    want = np.asarray(jpointcnn._forward_batched_starts(
        j.params, pc, valid, jnp.asarray(pad[:, 0]), jnp.asarray(pad[:, 1]),
        jnp.float32(j.pool), m1, m2))
    got = pointcnn.pointcnn_logits_batched(t, patches, starts=st, device=CPU)
    for i, n in enumerate(lens):
        assert got[i].shape == (n, 2)
        np.testing.assert_allclose(got[i], want[i, :n], rtol=0, atol=1e-3)


def test_key_derived_starts_match_jax():
    """The starts the JAX forward draws on the device from a key."""
    key = np.asarray(jax.random.PRNGKey(11))
    lens = [100, 128, 1, 64]
    valid = jnp.asarray(np.arange(128)[None, :] < np.array(lens)[:, None])
    ks = jax.vmap(jax.random.split)(jax.random.split(key, len(lens)))
    s1 = jax.vmap(jpointcnn._random_valid_index)(ks[:, 0], valid)
    valid2 = jpointcnn._pool_valid(valid, jnp.float32(0.6), 77)
    s2 = jax.vmap(jpointcnn._random_valid_index)(ks[:, 1], valid2)
    got = pointcnn.key_starts(key, lens, 0.6, 77)
    np.testing.assert_array_equal(got, np.stack([s1, s2], axis=1))
    np.testing.assert_array_equal(pointcnn.centroid_starts(_patches(2, (40, 70))),
                                  jpointcnn.centroid_starts(_patches(2, (40, 70))))


@pytest.mark.parametrize("fps_starts,vote_starts", [("centroid", 1), ("rng", 1),
                                                    ("rng", 2)])
def test_ensemble_votes_identical(models, fps_starts, vote_starts):
    patches = _patches(4, (110, 128, 60, 97))
    key = np.asarray(jax.random.PRNGKey(1))
    want = jinference.ensemble_vote_patches(
        [j for j, _ in models], patches, key=key, vote_starts=vote_starts,
        fps_starts=fps_starts)
    got = inference.ensemble_vote_patches(
        [t for _, t in models], patches, key=key, vote_starts=vote_starts,
        fps_starts=fps_starts)
    for (gf, gp), (wf, wp) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gp, wp, atol=1e-4)


def test_single_patch_vote_matches_jax(models):
    patch = _patches(5, (90,))[0]
    key = np.asarray(jax.random.PRNGKey(2))
    gf, gp = inference.ensemble_vote([t for _, t in models], patch, key=key)
    wf, wp = jinference.ensemble_vote([j for j, _ in models], patch, key=key)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gp, wp, atol=1e-4)


def test_torch_rng_replay_raises_naming_its_slice(models):
    """The replay takes one start per model: with vote_starts > 1 or
    fps_starts='centroid' it raises the JAX package's ValueError."""
    from dipole_tpu.utils.torch_rng import TorchMT19937 as JaxMT
    from dipole_tpu_torch.utils.torch_rng import TorchMT19937

    patches = _patches(6, (50,))
    for kw, match in (({"vote_starts": 2}, "vote_starts"),
                      ({"fps_starts": "centroid"}, "centroid")):
        with pytest.raises(ValueError, match=match):
            jinference.ensemble_vote_patches([models[0][0]], patches,
                                             torch_rng=JaxMT(1), **kw)
        with pytest.raises(ValueError, match=match):
            inference.ensemble_vote_patches([models[0][1]], patches,
                                            torch_rng=TorchMT19937(1), **kw)
