"""Port fields (dipole_tpu_torch.ops.fields) against dipole_tpu.ops.fields on
JAX-CPU and the Pallas kernels in interpret mode: the same numpy inputs from
a seed go through both."""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dipole_tpu.ops import fields as jfields
from dipole_tpu.ops import fields_pallas as jpallas
from dipole_tpu_torch.ops import _build, fields, fields_cuda
from dipole_tpu_torch.utils.io import gen_grid
from tests.conftest import make_sphere, scramble_signs


def random_cloud(n, seed=0):
    r = np.random.default_rng(seed)
    pc = r.normal(size=(n, 6)).astype(np.float32)
    pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=1, keepdims=True)
    return pc


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _assert_potential_close(got, want):
    # the sums run in other orders: rtol 1e-4 per target, plus an absolute
    # floor of 1e-5 of the largest |phi| for targets whose sum cancels
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_potential_matches_xla():
    src, tgt = random_cloud(600, 3), random_cloud(300, 4)
    got = fields.potential(_t(src), _t(tgt)).numpy()
    _assert_potential_close(got, np.asarray(jfields.potential(src, tgt)))


def test_potential_matches_pallas_interpret():
    src, tgt = random_cloud(600, 3), random_cloud(300, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpallas.potential_pallas(src, tgt))
    _assert_potential_close(fields.potential(_t(src), _t(tgt)).numpy(), want)


def test_potential_coincident_pair_is_exactly_zero():
    """A target on a source gets 0/0, which poisons its total: the total is
    scrubbed to exactly 0, the other targets are untouched."""
    src, tgt = random_cloud(500, 5), random_cloud(200, 6)
    tgt[17, :3] = src[42, :3]
    got = fields.potential(_t(src), _t(tgt)).numpy()
    want = np.asarray(jfields.potential(src, tgt))
    assert got[17] == 0.0 and want[17] == 0.0
    _assert_potential_close(got, want)


def test_potential_rsqrt_cubed_formula_keeps_the_poisoning():
    """csrc/potential.cu's arithmetic in float32: ir = 1/sqrt(r2), a
    subnormal r2 taken as 0 (rsqrt.approx.ftz), phi += ((c ir) ir) ir. A
    lattice point on a source makes its total NaN (c ir = 0 inf), a source
    1e-20 from a target makes that total non-finite (r2 subnormal); both are
    0 once scrubbed, as in the plain version, and the other targets stay
    within the kernel's tolerance of potential_plain."""
    src = _t(random_cloud(3000, 19))
    tgt = torch.cat([torch.as_tensor(gen_grid(10)), torch.zeros((1, 3))])
    src[5, :3] = tgt[555]                      # a lattice point on a source
    src[6, :3] = torch.tensor([1e-20, 0.0, 0.0])   # r2 = 1e-40 at the origin
    Rx, Ry, Rz = (src[:, k] - tgt[:, k:k + 1] for k in range(3))
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    assert 0 < float(r2[1000, 6]) < torch.finfo(torch.float32).tiny
    r2 = torch.where(r2 < torch.finfo(torch.float32).tiny, torch.zeros_like(r2), r2)
    ir = torch.rsqrt(r2)
    c = src[:, 3] * Rx + src[:, 4] * Ry + src[:, 5] * Rz
    raw = (c * ir * ir * ir).sum(1)
    assert torch.isnan(raw[555]) and not torch.isfinite(raw[1000])
    got = torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))
    want = fields.potential_plain(src, tgt)
    assert float(got[555]) == float(want[555]) == 0.0
    assert float(got[1000]) == float(want[1000]) == 0.0
    assert int(torch.isfinite(raw).sum()) == len(tgt) - 2
    _assert_potential_close(got.numpy(), want.numpy())


def test_potential_spans_several_plain_tiles(monkeypatch):
    """The plain version's source tiling adds tile sums in order."""
    monkeypatch.setattr(fields, "_PLAIN_BLOCK_S", 64)
    src, tgt = random_cloud(300, 7), random_cloud(50, 8)
    _assert_potential_close(fields.potential(_t(src), _t(tgt)).numpy(),
                            np.asarray(jfields.potential(src, tgt)))


def test_measure_mean_potential_matches_xla():
    pc = make_sphere(800, seed=9)
    got = fields.measure_mean_potential(pc, device="cpu")
    want = jfields.measure_mean_potential(pc)
    # a mean of 1000 lattice potentials: rtol 1e-4 of the sum-order noise
    assert got == pytest.approx(want, rel=1e-4)
    assert got > 0  # outward normals: positive mean, no global flip


def _cloud_with_duplicates(n=300, seed=10):
    pc = scramble_signs(make_sphere(n, seed=seed), seed=seed + 1)[0]
    pc[n - 40:] = pc[:40]          # coincident pairs
    return pc


def test_interaction_matrix_matches_xla():
    pc = _cloud_with_duplicates()
    got = fields.dipole_interaction_matrix(_t(pc)).numpy()
    want = np.asarray(jfields.dipole_interaction_matrix(pc))
    # the same formula; XLA may contract mul+add into FMA: rtol 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert (got[np.arange(260, 300), np.arange(0, 40)] == 0).all()


def test_interaction_matrix_targets_matches_xla():
    pc = _cloud_with_duplicates(seed=12)
    tgt = random_cloud(120, 13)
    got = fields.dipole_interaction_matrix(_t(pc), targets=_t(tgt)).numpy()
    want = np.asarray(jfields.dipole_interaction_matrix(pc, targets=tgt))
    assert got.shape == (120, 300)
    # off-cloud targets give entries that cancel to near 0 (3c.Rn/.. against
    # pn/..): rtol 1e-5 plus an absolute floor of 1e-6 of the largest entry
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_interaction_matrix_mirror_identity_is_exact(eps):
    """The identity csrc/imatrix.cu's symmetric dipole mode rests on: from
    the terms of pair (i, j) (source j at target i), I[j, i] = -((3 Rn) c /
    D - pn / denom) where I[i, j] = -((3 c) Rn / D - pn / denom), bit for
    bit, though I is not symmetric in float32."""
    pc = _cloud_with_duplicates(n=700, seed=18)   # 40 coincident pairs
    pc[600, :3] = 0.0                             # a pair 1e-22 apart: D
    pc[601, :3] = [1e-22, 0.0, 0.0]               # underflows, its entries overflow
    pts = _t(pc)
    tx, ty, tz, nx, ny, nz = (pts[:, k:k + 1] for k in range(6))
    sx, sy, sz, px, py, pz = (pts[:, k] for k in range(6))
    Rx, Ry, Rz = sx - tx, sy - ty, sz - tz
    r2 = Rx * Rx + Ry * Ry + Rz * Rz
    zero = r2 == 0.0
    denom = fields.sqrt_rn(r2) * r2 + eps
    c = px * Rx + py * Ry + pz * Rz
    Rn = nx * Rx + ny * Ry + nz * Rz
    pd = (px * nx + py * ny + pz * nz) / denom
    D = torch.where(zero, torch.ones_like(r2), r2) * denom

    def value(first, second):
        v = -(3.0 * first * second / D - pd)
        return torch.where(zero | ~torch.isfinite(v), torch.zeros_like(v), v)

    I = fields.dipole_interaction_matrix_plain(pts, pts, eps)
    assert torch.equal(value(c, Rn), I)
    assert torch.equal(value(Rn, c), I.t())
    assert not torch.equal(I, I.t())
    assert float(I[600, 601]) == 0.0 and float(I[601, 600]) == 0.0
    dup = (torch.arange(660, 700), torch.arange(40))
    assert bool((I[dup] == 0).all()) and bool((I.t()[dup] == 0).all())


def test_interaction_matrix_matches_pallas_interpret():
    pc = _cloud_with_duplicates(seed=14)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpallas.dipole_interaction_matrix_pallas(pc))
    got = fields.dipole_interaction_matrix(_t(pc)).numpy()
    # the Pallas kernel divides once (t = 1/(r2*denom)); the port divides
    # twice like the XLA formula: rtol 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_interaction_matrix_spans_several_plain_tiles(monkeypatch):
    monkeypatch.setattr(fields, "_PLAIN_BLOCK_T", 32)
    pc = _cloud_with_duplicates(n=100, seed=15)
    got = fields.dipole_interaction_matrix(_t(pc)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jfields.dipole_interaction_matrix(pc)), rtol=1e-5, atol=0)


def test_plain_sqrt_is_correctly_rounded():
    """The plain versions' root equals the float64 root rounded once to
    float32 (IEEE sqrtf, as in the kernels) on every element."""
    x = (np.random.default_rng(17).random(100_003).astype(np.float32) * 4) ** 3
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    for off in (0, 1, 3):
        got = fields.sqrt_rn(_t(x[off:])).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want[off:].view(np.int32))


@pytest.mark.parametrize("call", [
    lambda t: fields_cuda.potential(t, t[:, :3].contiguous()),
    lambda t: fields_cuda.dipole_imatrix(t, t, 1e-6),
], ids=["potential", "imatrix"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(_t(random_cloud(10, 16)))


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all()
