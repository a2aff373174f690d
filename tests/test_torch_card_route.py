"""orient_simple's card route, held on the CPU: utils/io.TensorTransform
against Transform bit for bit, and the route's stages on CPU tensors
(api._orient_simple_card, each stage's tensor form) against the host
route's numpy stages. On a CUDA device tests/test_torch_gpu.py holds the
route itself to the host-staged sequence."""
import numpy as np
import pytest
import torch

from dipole_tpu_torch import api
from dipole_tpu_torch.ops import estimate, fields, propagate
from dipole_tpu_torch.utils.io import Transform, TensorTransform, gen_grid
from dipole_tpu_torch.utils.timing import timer_factory

CPU = torch.device("cpu")


def _sphere(n, seed, first_inward=False):
    """A scrambled unit sphere with its normals (N, 6) float32, off the
    origin and stretched so that neither the centre nor the scale is round;
    the first point's normal outward, or inward (the sign fix then flips
    the oriented cloud)."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pc = np.concatenate([v, v], axis=1)
    pc[r.random(n) < 0.5, 3:] *= -1
    pc[0, 3:] = -pc[0, :3] if first_inward else pc[0, :3]
    pc[:, :3] = pc[:, :3] * [0.41, 0.29, 0.23] + [0.3, -1.7, 5.1]
    return pc.astype(np.float32)


def _transform_case(case):
    """(cloud as numpy, host positions whose mean is the centre)."""
    if case == "zero extent":
        pc = np.tile(np.float32([[0.3, -0.2, 0.1, 0.0, 0.6, 0.8]]), (50, 1))
        return pc, pc
    pc = _sphere(180001 if case == "180001 points" else 4000, 9)
    if case == "7 columns":
        pc = np.concatenate([pc, pc[:, :1]], axis=1)
    if case == "contiguous (N, 3) positions":
        return pc, np.ascontiguousarray(pc[:, :3])
    return pc, pc


@pytest.mark.parametrize("case", ["(N, 6) cloud", "zero extent",
                                  "contiguous (N, 3) positions", "180001 points",
                                  "7 columns"])
def test_tensor_transform_is_transform_bit_for_bit(case):
    """apply and inverse on a CPU tensor give Transform's bits; the centre
    from a C-ordered (N, 3) copy of the positions equals Transform's from
    the (N, 6) array's strided view; a zero-extent cloud takes scale 1."""
    pc, pos = _transform_case(case)
    want = Transform(pc)
    got = TensorTransform(pos, torch.from_numpy(pc))
    np.testing.assert_array_equal(got.center.numpy(), want.center)
    assert got.scale.dtype == torch.float32 and float(got.scale) == want.scale
    if case == "zero extent":
        assert want.scale == 1.0
    applied = want.apply(pc)
    np.testing.assert_array_equal(got.apply(torch.from_numpy(pc)).numpy(), applied)
    np.testing.assert_array_equal(got.inverse(torch.from_numpy(applied)).numpy(),
                                  want.inverse(applied))


def test_tensor_transform_leaves_its_input_alone():
    pc = _sphere(300, 3)
    t = torch.from_numpy(pc.copy())
    tr = TensorTransform(pc, t)
    tr.inverse(tr.apply(t))
    np.testing.assert_array_equal(t.numpy(), pc)


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("case", ["6 columns", "6 columns flipped", "3 columns",
                                  "zero extent", "estimate on 6 columns"])
def test_card_route_stages_on_cpu_tensors_equal_the_host_route(case, diffuse):
    """The card route's composition, run on CPU tensors, gives the host
    route's answer bit for bit: with and without the diffuse re-vote, where
    the sign fix flips the cloud (the first normal inward), where every
    point is the same, and where normals are given but estimated anew."""
    if case == "zero extent":
        pc = np.tile(np.float32([[0.3, -0.2, 0.1, 0.0, 0.6, 0.8]]), (40, 1))
    else:
        pc = _sphere(600, 5, first_inward="flipped" in case)
    if case == "3 columns":
        pc = (pc[:, :3] - [0.3, -1.7, 5.1]).astype(np.float32)
    api.ORIENT_SIMPLE_ROUTES.update(card=0, host=0)
    est = case.startswith("estimate")
    want = api.orient_simple(pc, diffuse=diffuse, estimate=est, device="cpu")
    assert api.ORIENT_SIMPLE_ROUTES == {"card": 0, "host": 1}
    got = api._orient_simple_card(pc, diffuse, est, 30, timer_factory(), CPU)
    assert got.dtype == np.float32 and got.shape == (len(pc), 6)
    np.testing.assert_array_equal(got, want)
    if case.startswith("6 columns"):
        staged, _ = Transform.trans(pc)
        oriented = host_propagation(staged, diffuse, "cpu")
        assert (fields.measure_mean_potential(oriented, device="cpu") < 0) == \
            ("flipped" in case)


def host_propagation(pc, diffuse, device):
    """strongest_field_propagation_points as a numpy formula: the greedy's
    acc and sign copied back, then the diffuse re-vote and the flips in
    numpy (reference field_utils.py:353-388)."""
    acc, sign = propagate.greedy_sign_sequence(pc, device=device)
    acc, sign = acc.cpu().numpy(), sign.cpu().numpy()
    if diffuse:
        sign = sign * np.where(acc * sign > 0, 1.0, -1.0).astype(np.float32)
    out = pc.copy()
    out[:, 3:6] *= sign[:, None]
    return out


@pytest.mark.parametrize("diffuse", [False, True])
def test_propagation_takes_a_tensor_and_gives_one(diffuse):
    """A tensor in gives a new tensor, numpy in gives numpy, and both give
    the numpy formula's bits; the input is left alone."""
    pc, _ = Transform.trans(_sphere(500, 6))
    want = host_propagation(pc, diffuse, "cpu")
    t = torch.from_numpy(pc.copy())
    got = propagate.strongest_field_propagation_points(t, diffuse=diffuse, device="cpu")
    assert isinstance(got, torch.Tensor) and got is not t
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), pc)
    got = propagate.strongest_field_propagation_points(pc, diffuse=diffuse, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pc, t.numpy())


def test_estimate_normals_tensor_is_the_wrapper_before_its_copy_back():
    pos = _sphere(800, 7)[:, :3] - np.float32([0.3, -1.7, 5.1])
    got = estimate.estimate_normals_tensor(pos, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), estimate.estimate_normals(pos, device="cpu"))


def test_sign_fix_lattice_is_gen_grid_kept_once_a_device():
    a = fields._lattice(CPU)
    assert a is fields._lattice(CPU)
    np.testing.assert_array_equal(a.numpy(), gen_grid(10))
