"""The torch_rng replay: the port's TorchMT19937 (dipole_tpu_torch.utils.
torch_rng) against the JAX package's and against torch's own generator, the
reference canonicalization, and ensemble votes with replayed starts against
dipole_tpu's on JAX-CPU."""
from pathlib import Path

import numpy as np
import pytest
import torch

from dipole_tpu.models import inference as jinference
from dipole_tpu.models import pointcnn as jpointcnn
from dipole_tpu.utils.torch_rng import TorchMT19937 as JaxMT19937
from dipole_tpu_torch import api
from dipole_tpu_torch.models import inference, pointcnn
from dipole_tpu_torch.utils.torch_rng import TorchMT19937
from tests.conftest import make_sphere, scramble_signs

ROOT = Path(__file__).resolve().parent.parent
TRIO = [ROOT / "pre_trained_tpu" / f"dipole_{i}.pt" for i in range(3)]


def _ranges(seed, count):
    """n from 1 to 2**31 - 1: small patch sizes, powers of two and their
    neighbours, and uniform draws over the whole range."""
    r = np.random.default_rng(seed)
    edges = [1, 2, 3, 624, 1000, 2**16, 2**28 - 1, 2**28, 2**30, 2**31 - 1]
    return np.concatenate([edges, r.integers(1, 5000, count // 2),
                           r.integers(1, 2**31, count - count // 2 - len(edges))])


@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
def test_stream_matches_jax_twister(seed):
    """10^4 draws (16 regenerations of the 624-word state), draw for draw."""
    ours, want = TorchMT19937(seed), JaxMT19937(seed)
    for n in _ranges(seed, 10000):
        assert ours.randint(int(n)) == want.randint(int(n)), n
    for bad in (0, -1, 2**32):
        with pytest.raises(ValueError):
            ours.randint(bad)


@pytest.mark.parametrize("seed", [1, 7])
def test_stream_matches_torch_randint_below_2_28(seed):
    """torch.randint under torch.manual_seed, 10^4 draws. torch 2.13 takes a
    64-bit draw (two words) for n >= 2**28 where the reference's torch took
    one, so the reference's stream is held to it below that: every patch
    size."""
    r = np.random.default_rng(seed)
    ns = np.concatenate([[1, 2, 2**28 - 1], r.integers(1, 5000, 5000),
                         r.integers(1, 2**28, 4997)])
    ours = TorchMT19937(seed)
    state = torch.random.get_rng_state()
    try:
        torch.manual_seed(seed)
        for n in ns:
            assert ours.randint(int(n)) == int(torch.randint(int(n), (1,))), n
    finally:
        torch.random.set_rng_state(state)


def test_chip_smoke_constant_is_the_jax_stream():
    """chip_smoke.py holds the card's replay to its first 32 draws."""
    import chip_smoke

    want = JaxMT19937(1)
    assert list(chip_smoke.TORCH_RNG_FIRST_32) == [want.randint(1000)
                                                   for _ in range(32)]


@pytest.mark.parametrize("n", [21, 100, 511])
def test_canon_reference_bit_equal(n):
    r = np.random.default_rng(n)
    patch = (r.normal(size=(n, 6)) * [2, 1, 0.3, 1, 1, 1] + [5, -1, 0, 0, 0, 0]
             ).astype(np.float32)
    np.testing.assert_array_equal(inference._canon_reference(patch),
                                  jinference._canon_reference(patch))


@pytest.fixture(scope="module")
def trio():
    out = []
    for path in TRIO:
        j = jpointcnn.PointCNNParams.from_files(path)
        out.append((j, pointcnn.PointCNN.from_files(path)))
    return out


def _patches(seed, sizes):
    r = np.random.default_rng(seed)
    sp = make_sphere(3000, seed=seed, noise=0.01)
    out = []
    for n in sizes:
        c = sp[r.integers(len(sp)), :3]
        p = sp[np.argsort(((sp[:, :3] - c) ** 2).sum(1))[:n]].copy()
        p[r.random(n) < 0.3, 3:] *= -1
        out.append(p)
    return out


def test_ensemble_votes_with_replayed_starts_match_jax(trio):
    """The v1 trio over 6 ragged patches, two calls on one stream: the same
    starts (each stream left at the same place), flips equal, probabilities
    within 1e-5 (float32 sums in other orders)."""
    patches = _patches(11, (128, 60, 97, 21, 110, 128))
    jrng, trng = JaxMT19937(1), TorchMT19937(1)
    for _ in range(2):
        want = jinference.ensemble_vote_patches([j for j, _ in trio], patches,
                                                torch_rng=jrng)
        got = inference.ensemble_vote_patches([t for _, t in trio], patches,
                                              torch_rng=trng)
        for (gf, gp), (wf, wp) in zip(got, want):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5)
        assert trng.randint(2**31 - 1) == jrng.randint(2**31 - 1)


def test_orient_patches_torch_rng_is_deterministic_and_replays():
    """api.orient_patches(torch_rng=1): one stream a call, so two calls give
    the same cloud, and it orients the sphere."""
    gt = make_sphere(700, seed=4)
    pc = scramble_signs(gt, seed=5)[0]
    kw = dict(models=[str(TRIO[0])], number_parts=4, minimum_points_per_patch=20,
              iters=2, propagation_iters=1, device="cpu")
    a = api.orient_patches(pc, torch_rng=1, **kw)
    np.testing.assert_array_equal(a, api.orient_patches(pc, torch_rng=1, **kw))
    agree = float(((a[:, 3:] * gt[:, 3:]).sum(1) > 0).mean())
    assert max(agree, 1 - agree) >= 0.95
