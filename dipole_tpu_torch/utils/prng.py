"""Threefry-2x32 counter-based keys in numpy, bit for bit those of
`jax.random` with raw uint32[2] keys and jax_threefry_partitionable on (the
default of JAX 0.5 and later).

The JAX package draws every FPS start of the PointCNN ensemble from such keys
(dipole_tpu/models/pointcnn.py:203-208, :425-440, :700-701;
dipole_tpu/models/inference.py:66-78, :199-212). The port draws the same
start indices on the host, so both packages make the same ensemble
decisions from the same vote seed.

A key is a numpy uint32 array of shape (2,); `uniform`, `split2` and
`random_valid_index` also take a batch of keys (..., 2), one draw each, as
jax.vmap over them would. Functions:
    prng_key(seed)          jax.random.PRNGKey(seed)
    split(key, num)         jax.random.split(key, num)   -> (num, 2)
    split2(keys)            jax.vmap(jax.random.split)(keys) as two batches
    fold_in(key, data)      jax.random.fold_in(key, data)
    uniform(keys)           jax.random.uniform(key)      (float32 in [0, 1))
    uniform_shape(key, shape, minval, maxval)
                            jax.random.uniform(key, shape, float32, minval, maxval)
    randint(key, shape, minval, maxval)
                            jax.random.randint(key, shape, minval, maxval) (int32)
    random_valid_index(keys, n_valid)
                            pointcnn._random_valid_index on a prefix mask
"""
from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "prng_key", "split", "split2", "fold_in",
           "uniform", "uniform_shape", "randint", "random_valid_index"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), as
    jax's threefry2x32_p: keys (..., 2) uint32 broadcast against the
    counters x0/x1 (uint32 arrays of one shape). Returns the two output
    words."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a 32-bit seed: (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split: key i is the hash of the counter pair (0, i)."""
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def split2(keys):
    """(first, second) halves of jax.random.split(key) for every key of a
    batch (..., 2): the hashes of the counter pairs (0, 0) and (0, 1)."""
    keys = np.asarray(keys, np.uint32)
    zero = np.zeros(keys.shape[:-1], np.uint32)
    return tuple(np.stack(threefry2x32(keys, zero, zero + np.uint32(i)), axis=-1)
                 for i in (0, 1))


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in: the hash of the counter pair (0, data mod 2^32)."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def uniform(keys):
    """jax.random.uniform(key) (shape (), float32) for a key (2,) or each
    key of a batch (..., 2): the 23 high bits of bits0 ^ bits1 at counter
    (0, 0) as the mantissa of a float in [1, 2), minus 1."""
    keys = np.asarray(keys, np.uint32)
    zero = np.zeros(keys.shape[:-1], np.uint32)
    b0, b1 = threefry2x32(keys, zero, zero)
    bits = np.asarray((b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000))
    return bits.view(np.float32) - np.float32(1.0)


def _random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) in 32 bits: element i hashes the counter
    pair (hi(i), lo(i)) of its flat index and keeps bits0 ^ bits1."""
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform_shape(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval): floats in
    [1, 2) from the 23 high bits, minus 1, then floats * (max - min) + min
    and max(min, .), each rounded to float32 (the scalar `uniform` is
    shape () with the default range)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = _random_bits(key, tuple(shape)) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def randint(key, shape, minval, maxval) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) in int32: two 32-bit
    draws from split(key) reduced modulo the span as JAX reduces them, with
    uint32 wrap-around (a span <= 0 gives minval)."""
    shape = tuple(shape)
    k1, k2 = split(key, 2)
    hi_bits, lo_bits = _random_bits(k1, shape), _random_bits(k2, shape)
    lo, hi = np.int64(minval), np.int64(maxval)
    span = np.uint64(1 if hi <= lo else (hi - lo) & 0xFFFFFFFF)
    mask = np.uint64(0xFFFFFFFF)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult & mask) % span
    off = ((hi_bits.astype(np.uint64) % span) * mult
           + lo_bits.astype(np.uint64) % span) & mask
    return (lo + (off % span).astype(np.int64)).astype(np.int32)


def random_valid_index(keys, n_valid):
    """pointcnn._random_valid_index for masks whose n_valid valid rows come
    first: min(int32(u * n_valid), n_valid - 1) in float32, and 0 when no
    row is valid (jnp.argmax of an all-False mask). keys (2,) or (..., 2)
    with n_valid broadcast against them; an int or an int64 array."""
    n = np.asarray(n_valid, np.int64)
    k = (uniform(keys) * n.astype(np.float32)).astype(np.int64)
    out = np.where(n > 0, np.minimum(k, n - 1), 0)
    return int(out) if out.ndim == 0 else out
