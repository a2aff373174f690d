"""The port's checkpoint writer (dipole_tpu_torch.models.checkpoints.
save_state_dict) through both readers: the port's (torch.load, weights only)
and the JAX package's restricted unpickler, bit for bit."""
from collections import OrderedDict

import jax
import numpy as np
import torch

from dipole_tpu import train as jtrain
from dipole_tpu.models import checkpoints as jcheckpoints
from dipole_tpu_torch import train
from dipole_tpu_torch.models import checkpoints, pointcnn
from dipole_tpu_torch.utils import prng


def _read_both(path):
    return checkpoints.load_state_dict(path), jcheckpoints.load_state_dict(path)


def test_round_trip_through_both_readers(tmp_path):
    """numpy arrays and tensors (a non-contiguous view, one on another
    tensor's storage), float32, float64, int64 and bool: keys in order,
    values and dtypes bit-equal."""
    r = np.random.default_rng(0)
    big = torch.tensor(r.normal(size=(6, 4)).astype(np.float32))
    sd = OrderedDict([
        ("a.weight", r.normal(size=(4, 3)).astype(np.float32)),
        ("a.bias", np.zeros(4, np.float32)),
        ("view.t", big.t()),
        ("view.row", big[2]),
        ("f64", r.normal(size=(5,))),
        ("idx", np.arange(6, dtype=np.int64).reshape(2, 3)),
        ("mask", r.random(7) < 0.5),
    ])
    p = tmp_path / "rt.pt"
    checkpoints.save_state_dict(sd, p)
    for back in _read_both(p):
        assert list(back) == list(sd)
        for k, v in sd.items():
            want = v.numpy() if isinstance(v, torch.Tensor) else v
            assert back[k].dtype == want.dtype, k
            np.testing.assert_array_equal(back[k], want)


def test_trained_model_round_trip_and_jax_writer(tmp_path):
    """A fresh model's state_dict written by the port reloads into the same
    logits (PointCNN.from_files); the JAX package's writer and the port's
    give the same arrays through the port's reader."""
    params = train.init_params(prng.prng_key(2))
    model = pointcnn.from_numpy_params(params, 0.6, trainable=True)
    p = tmp_path / "model.pt"
    checkpoints.save_state_dict(model.state_dict(), p)
    p.with_suffix(".txt").write_text("pool: 0.6\n")
    back = pointcnn.PointCNN.from_files(p)
    patch = train._probe_patch(3, 100)
    np.testing.assert_array_equal(pointcnn.pointcnn_logits(back, patch),
                                  pointcnn.pointcnn_logits(model, patch))
    q = tmp_path / "jax.pt"
    jcheckpoints.save_state_dict(
        {k: np.asarray(v) for k, v in jtrain.init_params(jax.random.PRNGKey(2)).items()}, q)
    ours, theirs = _read_both(p)
    from_jax = checkpoints.load_state_dict(q)
    assert set(from_jax) == set(ours)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
        # the two packages' init draws agree to 1 ulp of the range (prng)
        np.testing.assert_allclose(ours[k], from_jax[k], rtol=0,
                                   atol=np.spacing(np.abs(from_jax[k]).max()))
