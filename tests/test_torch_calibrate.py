"""train.calibrate_init against dipole_tpu.train.calibrate_init on JAX-CPU,
from the same JAX-initialised parameters and probe patch.

At the 128-point probe each calibrated tensor is within 4 ulp of its range
(read: 3): the std is ddof 0 on both sides, and ddof 1 would move the lin4
scale by 2e-3 (256 elements). At the 512-point probe the FPS picks of the
two packages part at near-ties (JAX-CPU fuses the distance's multiply and
add into an FMA), so the stages after the first FPS take other points and
their scales move apart: the test reports the largest relative move of a
scale (read: 9.5e-4, at encoder.conv3) and holds it under 2e-3, while the
first stage, before any FPS, stays within 4 ulp."""
import jax
import numpy as np
import pytest

from dipole_tpu import train as jtrain
from dipole_tpu_torch import train

FIRST_STAGE = "encoder.conv1.conv.2"


@pytest.mark.parametrize("n", [128, 512])
def test_calibrate_init_matches_jax(n):
    p0 = {k: np.asarray(v) for k, v in jtrain.init_params(jax.random.PRNGKey(0)).items()}
    probe = train._probe_patch(0, n)
    want = {k: np.asarray(v) for k, v in jtrain.calibrate_init(p0, probe).items()}
    got = train.calibrate_init(p0, probe, device="cpu")
    assert list(got) == list(want)
    moves = {}
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if np.array_equal(w, p0[k]):           # not a calibrated tensor
            np.testing.assert_array_equal(g, p0[k])
            continue
        ulps = np.abs(g - w).max() / np.spacing(np.float32(np.abs(w).max()))
        i = int(np.argmax(np.abs(p0[k])))
        moves[k] = abs((g.flat[i] / p0[k].flat[i]) / (w.flat[i] / p0[k].flat[i]) - 1)
        if n == 128 or k.startswith(FIRST_STAGE):
            assert ulps <= 4, (k, ulps)
    worst = max(moves, key=moves.get)
    print(f"n={n}: largest scale move {moves[worst]:.3e} at {worst}")
    assert len(moves) == 8                      # seven conv.2 and lin4 weights
    assert moves[worst] < 2e-3, (worst, moves[worst])
