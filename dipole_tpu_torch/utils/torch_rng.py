"""The reference's FPS-start stream: torch's CPU Mersenne Twister — the
port's own copy of dipole_tpu/utils/torch_rng.py.

The reference pipelines pin `torch.manual_seed(1)` and draw every FPS random
start from torch's global CPU generator, one `torch.randint(n, (1,))` per
pooling stage (orient_pointcloud.py:8, pointcnn.py:68,73). Torch's CPU
generator is a standard MT19937 seeded with the raw 32-bit seed, and the
reference's torch reduces one 32-bit draw modulo n for every n < 2**32.

The stream is kept in Python rather than drawn from a `torch.Generator`:
torch 2.13 takes two 32-bit words (a 64-bit draw) for n >= 2**28, where the
reference's torch and the JAX package take one, so a torch generator would
leave the reference's stream above that range. Below it (every patch size)
the two are the same, draw for draw.
"""
from __future__ import annotations

__all__ = ["TorchMT19937"]

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class TorchMT19937:
    """MT19937 with torch's seeding (state[0] = seed & 0xffffffff, Knuth's
    multiplier recurrence) and the reference's randint (one 32-bit draw,
    reduced modulo n) for 0 < n < 2**32."""

    def __init__(self, seed: int = 1):
        self.mt = [0] * _N
        self.mt[0] = seed & _MASK32
        for i in range(1, _N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30))
                          + i) & _MASK32
        self.index = _N

    def _generate(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            nxt = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                nxt ^= _MATRIX_A
            mt[i] = nxt
        self.index = 0

    def random32(self) -> int:
        """The next tempered 32-bit word."""
        if self.index >= _N:
            self._generate()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32

    def randint(self, n: int) -> int:
        """torch.randint(n, (1,)) of the reference's torch: one 32-bit draw
        reduced modulo n, for 0 < n < 2**32."""
        if not 0 < n < (1 << 32):
            raise ValueError(f"randint range must be in (0, 2^32): {n}")
        return self.random32() % n
