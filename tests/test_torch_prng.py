"""The port's numpy threefry keys (dipole_tpu_torch.utils.prng) bit for bit
against jax.random (partitionable threefry, JAX's default), and the FPS start
draw against dipole_tpu's _random_valid_index."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dipole_tpu.models import pointcnn as jpointcnn
from dipole_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_uniform_bit_equal(seed):
    key = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.prng_key(seed), key)
    for num in (1, 2, 5, 33):
        np.testing.assert_array_equal(prng.split(key, num),
                                      np.asarray(jax.random.split(key, num)))
    for data in (0, 3, 128, 1024, 0x9E3779B9 + 1, 0x9E3779B9 + 4, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(key, data)))
    sub = prng.split(key, 3)[2]
    assert prng.uniform(sub) == np.asarray(jax.random.uniform(sub))


def test_chained_derivation_matches_jax():
    """The ensemble's chain: split, fold in a digest, a vote start, a bucket,
    split per patch and per stage."""
    jkey = jax.random.PRNGKey(1)
    key = prng.prng_key(1)
    for digest in (251895702, 5):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key, 2)
        j = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jsub, digest), 0x9E3779B9 + 2), 512)
        k = prng.fold_in(prng.fold_in(prng.fold_in(sub, digest),
                                      0x9E3779B9 + 2), 512)
        np.testing.assert_array_equal(k, np.asarray(j))
        jk = jax.vmap(jax.random.split)(jax.random.split(j, 7))
        kk = np.stack([prng.split(x, 2) for x in prng.split(k, 7)])
        np.testing.assert_array_equal(kk, np.asarray(jk))


@pytest.mark.parametrize("n_valid,n_pad", [(1, 128), (77, 128), (128, 128),
                                           (300, 512), (1000, 1024), (0, 8)])
def test_random_valid_index_matches_jax(n_valid, n_pad):
    valid = jnp.asarray(np.arange(n_pad) < n_valid)
    for key in prng.split(prng.prng_key(n_valid + n_pad), 40):
        want = int(jpointcnn._random_valid_index(jnp.asarray(key), valid))
        assert prng.random_valid_index(key, n_valid) == want


SHAPES = [(), (1,), (7,), (3, 5), (13, 3, 2), (1024, 60)]


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_shape_matches_jax(seed, shape):
    """Bit-equal on [0, 1); on [-lim, lim) within 1 ulp of lim: XLA's CPU
    backend fuses floats * (max - min) + min into one FMA, the port rounds
    the product and the sum apart as the JAX program writes them (found:
    up to 1 ulp of lim, never more)."""
    key = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.uniform_shape(key, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    for lim in (np.float32(1.0), np.sqrt(np.float32(6.0 / 34)),
                np.sqrt(np.float32(6.0 / 784))):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, -lim, lim))
        got = prng.uniform_shape(key, shape, -lim, lim)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(lim))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("lo,hi", [(0, 2**31 - 1), (0, 5), (-3, 1000), (5, 5),
                                   (0, 70000), (9, 2)])
def test_randint_matches_jax(seed, lo, hi):
    key = np.asarray(jax.random.PRNGKey(seed))
    for shape in ((), (7,), (1024, 60)):
        np.testing.assert_array_equal(
            prng.randint(key, shape, lo, hi),
            np.asarray(jax.random.randint(key, shape, lo, hi)))
