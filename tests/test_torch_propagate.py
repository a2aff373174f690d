"""Port greedy propagation (dipole_tpu_torch.ops.propagate) against
dipole_tpu.ops.propagate on JAX-CPU and the three Pallas greedy kernels in
interpret mode: identical signs, acc allclose (rtol 1e-4, atol 1e-5)."""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dipole_tpu.ops import propagate as jprop
from dipole_tpu.ops import propagate_pallas as jpallas
from dipole_tpu_torch.ops import fields, propagate, propagate_cuda
from tests.conftest import make_sphere, scramble_signs


def _jax_greedy(pc, start, matrix_limit):
    acc, sign = jprop.greedy_sign_sequence(pc, start, matrix_limit=matrix_limit)
    return np.asarray(acc), np.asarray(sign)


def _port_greedy(pc, start, matrix_limit):
    acc, sign = propagate.greedy_sign_sequence(pc, start, matrix_limit=matrix_limit,
                                               device="cpu")
    return acc.numpy(), sign.numpy()


@pytest.mark.parametrize("matrix_limit", [None, 0], ids=["matrix", "columns"])
@pytest.mark.parametrize("start", [0, 7])
def test_greedy_matches_jax(matrix_limit, start):
    pc, _ = scramble_signs(make_sphere(400, seed=21), seed=22)
    acc_j, sign_j = _jax_greedy(pc, start, matrix_limit)
    acc_t, sign_t = _port_greedy(pc, start, matrix_limit)
    assert (sign_t == sign_j).all()
    assert set(np.unique(sign_t)) == {-1.0, 1.0}
    np.testing.assert_allclose(acc_t, acc_j, rtol=1e-4, atol=1e-5)


def test_greedy_noisy_cloud_with_duplicates_matches_jax():
    pc, _ = scramble_signs(make_sphere(300, seed=23, noise=0.02), seed=24)
    pc[280:] = pc[:20]            # coincident points: zero interaction
    for limit in (None, 0):
        acc_j, sign_j = _jax_greedy(pc, 3, limit)
        acc_t, sign_t = _port_greedy(pc, 3, limit)
        assert (sign_t == sign_j).all()
        np.testing.assert_allclose(acc_t, acc_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("matrix_limit", [None, 0], ids=["matrix", "columns"])
def test_greedy_ties_far_apart_in_index_match_jax(matrix_limit):
    """Point i + 150 duplicates point i: their columns agree and each adds 0
    to the other, so their |acc| tie exactly until the lower index is
    picked (on the card such pairs lie in different blocks)."""
    pc, _ = scramble_signs(make_sphere(300, seed=30, noise=0.01), seed=31)
    pc[150:] = pc[:150]
    acc_j, sign_j = _jax_greedy(pc, 4, matrix_limit)
    acc_t, sign_t = _port_greedy(pc, 4, matrix_limit)
    assert (sign_t == sign_j).all()
    np.testing.assert_allclose(acc_t, acc_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(acc_t[:150], acc_t[150:])   # tied all along


@pytest.mark.parametrize("mode", ["rows", "columns"])
def test_greedy_wrappers_refuse_more_than_2_24_points(mode):
    """The kernel's candidate key holds an index below 2^24 + 1: the
    wrappers refuse a larger cloud before they look at its device (meta
    tensors, so nothing is allocated)."""
    n = propagate_cuda.MAX_POINTS + 1
    with pytest.raises(ValueError, match="at most 2\\^24"):
        if mode == "rows":
            propagate_cuda.greedy_rows(torch.empty((n, n), device="meta"), 0)
        else:
            propagate_cuda.greedy_columns(torch.empty((n, 6), device="meta"), 0, 1e-6)


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("n", [500, 1200])
def test_strongest_field_propagation_points_matches_jax(diffuse, n):
    pc, _ = scramble_signs(make_sphere(n, seed=25, noise=0.01), seed=26)
    want = jprop.strongest_field_propagation_points(pc, diffuse=diffuse)
    got = propagate.strongest_field_propagation_points(pc, diffuse=diffuse,
                                                       device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_matrix_limit_picks_the_tier(monkeypatch):
    """Up to MATRIX_LIMIT the greedy reads matrix rows; above it, columns."""
    seen = []
    real_rows, real_cols = propagate.greedy_rows_plain, propagate.greedy_columns_plain
    monkeypatch.setattr(propagate, "greedy_rows_plain",
                        lambda *a: seen.append("rows") or real_rows(*a))
    monkeypatch.setattr(propagate, "greedy_columns_plain",
                        lambda *a: seen.append("columns") or real_cols(*a))
    monkeypatch.setattr(propagate, "MATRIX_LIMIT", 100)
    pc = make_sphere(100, seed=27)
    propagate.greedy_sign_sequence(pc, device="cpu")
    propagate.greedy_sign_sequence(make_sphere(101, seed=27), device="cpu")
    assert seen == ["rows", "columns"]


def test_greedy_edge_cases(monkeypatch):
    acc, sign = propagate.greedy_sign_sequence(np.zeros((1, 6), np.float32),
                                               device="cpu")
    assert acc.tolist() == [0.0] and sign.tolist() == [1.0]
    # the 2^24 ceiling is the card's alone: with it set to 0 the CPU loop
    # still runs, as the JAX XLA scan does at any size, and gives the plain
    # and the JAX result
    monkeypatch.setattr(propagate_cuda, "MAX_POINTS", 0)
    pc, _ = scramble_signs(make_sphere(51, seed=28), seed=29)
    acc_t, sign_t = _port_greedy(pc, 0, None)
    acc_p, sign_p = propagate.greedy_rows_plain(
        fields.dipole_interaction_matrix(torch.as_tensor(pc)), 0)
    np.testing.assert_array_equal(acc_t, acc_p.numpy())
    np.testing.assert_array_equal(sign_t, sign_p.numpy())
    acc_j, sign_j = _jax_greedy(pc, 0, None)
    assert (sign_t == sign_j).all()
    np.testing.assert_allclose(acc_t, acc_j, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="starting point"):
        propagate.greedy_sign_sequence(make_sphere(20, seed=28), 20, device="cpu")


def test_greedy_matches_pallas_resident_interpret():
    pc, _ = scramble_signs(make_sphere(300, seed=6), seed=7)
    with pltpu.force_tpu_interpret_mode():
        acc_p, sign_p = jpallas.greedy_sign_sequence_pallas(pc)
    acc_t, sign_t = _port_greedy(pc, 0, 0)
    assert (sign_t == sign_p).all()
    # single-reciprocal Pallas column vs the two-divide XLA formula
    np.testing.assert_allclose(acc_t, acc_p, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("kernel", ["streamed", "xl"])
def test_greedy_matches_pallas_streamed_and_xl_interpret(kernel):
    seed = {"streamed": 13, "xl": 31}[kernel]
    pc, _ = scramble_signs(make_sphere(500, seed=seed), seed=seed + 1)
    fn = {"streamed": jpallas.greedy_sign_sequence_pallas_streamed,
          "xl": jpallas.greedy_sign_sequence_pallas_xl}[kernel]
    with pltpu.force_tpu_interpret_mode():
        acc_p, sign_p = fn(pc, starting_point=7, eps=1e-6)
    acc_t, sign_t = _port_greedy(pc, 7, 0)
    assert (sign_t == sign_p).all()
    np.testing.assert_allclose(acc_t, acc_p, rtol=1e-4, atol=1e-5)


def test_greedy_kernel_wrappers_refuse_cpu_tensors():
    pc = torch.as_tensor(make_sphere(10, seed=29))
    with pytest.raises(ValueError, match="CUDA tensor"):
        propagate_cuda.greedy_columns(pc, 0, 1e-6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        propagate_cuda.greedy_rows(fields.dipole_interaction_matrix(pc), 0)
