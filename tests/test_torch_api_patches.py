"""The port's patch pipelines end to end (dipole_tpu_torch.api.orient_patches,
orient_large, transfer_orientation and their CLIs) on the CPU next to
dipole_tpu's on the same input and checkpoint.

The vote/propagation cascade is chaotic (ROADMAP.md ground rules), so the
pipelines are compared by GT sign agreement: the port's lies within 0.02 of
the JAX package's on the same input."""
import sys
from pathlib import Path

import numpy as np
import pytest

from dipole_tpu import api as japi
from dipole_tpu_torch import api
from dipole_tpu_torch.cli import dipole_api, orient_large, orient_pointcloud
from dipole_tpu_torch.cli import reference_orientation
from dipole_tpu_torch.ops.metrics import sign_agreement
from dipole_tpu_torch.utils import io
from tests.conftest import make_sphere, scramble_signs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import make_shape  # noqa: E402

CKPT = str(ROOT / "pre_trained_tpu" / "dipole_0.pt")
BAND = 0.02


@pytest.fixture(scope="module")
def hand():
    """A 2000-point metaball hand with exact GT normals."""
    return make_shape.metaball_cloud(2000, make_shape.hand_balls(3), iso=1.6,
                                     res=64, seed=3)


@pytest.mark.parametrize("estimate", [False, True], ids=["6col", "estimate"])
def test_orient_patches_gt_agreement_within_band(hand, estimate):
    inp = hand[:, :3].copy() if estimate else scramble_signs(hand, seed=7)[0]
    kw = dict(models=[CKPT], number_parts=8, minimum_points_per_patch=40,
              iters=2, propagation_iters=1, diffuse=True, weighted_prop=True,
              estimate=estimate)
    want = sign_agreement(japi.orient_patches(inp, **kw), hand)
    out = api.orient_patches(inp, device="cpu", **kw)
    assert out.shape == (2000, 6) and out.dtype == np.float32
    np.testing.assert_allclose(out[:, :3], hand[:, :3], atol=1e-5)
    got = sign_agreement(out, hand)
    assert abs(got - want) <= BAND and got >= 0.95


def test_orient_large_gt_agreement_within_band(hand):
    inp = scramble_signs(hand, seed=8)[0]
    kw = dict(models=[CKPT], number_parts=6, minimum_points_per_patch=40, iters=2)
    want = sign_agreement(japi.orient_large(inp, **kw), hand)
    got = sign_agreement(api.orient_large(inp, device="cpu", **kw), hand)
    assert abs(got - want) <= BAND and got >= 0.95


def test_model_free_patches_and_options():
    gt = make_sphere(600, seed=2)
    pc = scramble_signs(gt, seed=3)[0]
    kw = dict(number_parts=4, minimum_points_per_patch=20, iters=1,
              propagation_iters=1, diffuse=True, device="cpu")
    base = api.orient_patches(pc, **kw)
    assert sign_agreement(base, gt) == 1.0
    np.testing.assert_array_equal(base, japi.orient_patches(
        pc, **{k: v for k, v in kw.items() if k != "device"}))
    # vote_margin 0.5 suppresses every flip: the model-free run
    np.testing.assert_array_equal(
        api.orient_patches(pc, models=[CKPT], vote_margin=0.5, **kw), base)
    stats = {}
    api.orient_patches(pc, models=[CKPT], fix_models=[CKPT], fix_stats=stats, **kw)
    assert len(stats["passes"]) == 1
    for bad in ({"vote_starts": 2}, {"fps_starts": "centroid"}):
        with pytest.raises(ValueError, match="torch_rng"):
            api.orient_patches(pc, torch_rng=1, **bad, **kw)
        with pytest.raises(ValueError, match="torch_rng"):
            japi.orient_patches(pc, torch_rng=1, **bad, **{
                k: v for k, v in kw.items() if k != "device"})
    with pytest.raises(ValueError, match="fix_when"):
        api.orient_patches(pc, fix_when="never", **kw)
    cons = api.orient_patches_consensus(pc, runs=3, **kw)
    assert sign_agreement(cons, gt) == 1.0



def test_orient_large_np_has_the_api_defaults(hand, monkeypatch):
    """dipole_api.orient_large_np hands api.orient_large the arguments its
    JAX twin (JAX cli/dipole_api.py:26-43) hands the JAX api.orient_large,
    read from the twin itself by recording both calls: the same defaults,
    the same overrides, other keyword arguments dropped; each package's own
    DEFAULT_MODELS, and the port's device. Its output is the port's
    api.orient_large run with those recorded arguments."""
    from dipole_tpu.cli import dipole_api as jdipole_api

    pts = hand[::2, :3].copy()
    calls = {}

    def recorder(tag):
        def record(points, **kw):
            assert points is pts
            calls[tag] = kw
            return tag
        return record

    monkeypatch.setattr(japi, "orient_large", recorder("jax"))
    monkeypatch.setattr(api, "orient_large", recorder("port"))
    defaults = None
    for kw in ({}, {"iters": 2, "n": 12, "estimate_normals": False,
                    "curvature_threshold": 0.5, "mesh": 4, "seed": 3}):
        assert jdipole_api.orient_large_np(pts, **kw) == "jax"
        assert dipole_api.orient_large_np(pts, device="cpu", **kw) == "port"
        want, got = dict(calls["jax"]), dict(calls["port"])
        assert want.pop("models") == jdipole_api.DEFAULT_MODELS
        assert got.pop("models") == dipole_api.DEFAULT_MODELS
        assert got.pop("device") == "cpu"
        assert got == want
        defaults = defaults or want
        assert dipole_api.orient_large_np(pts, models=[CKPT], device="cpu",
                                          **kw) == "port"
        assert calls["port"]["models"] == [CKPT]
    monkeypatch.undo()
    got = dipole_api.orient_large_np(pts, device="cpu")
    want = api.orient_large(pts, models=dipole_api.DEFAULT_MODELS,
                            device="cpu", **defaults)
    assert got.shape == (1000, 6)
    np.testing.assert_array_equal(got, want)
    assert sign_agreement(got, hand[::2]) >= 0.9


def test_transfer_orientation_matches_jax():
    ref = make_sphere(400, seed=6)
    tgt = scramble_signs(make_sphere(200, seed=7), seed=8)[0]
    got = api.transfer_orientation(ref, tgt, device="cpu")
    np.testing.assert_array_equal(got, japi.transfer_orientation(ref, tgt))
    assert sign_agreement(got, make_sphere(200, seed=7)) == 1.0


def _outputs(out_dir, n):
    pc = io.load_xyz(out_dir / "final_result.xyz")
    opts = (out_dir / "opts.txt").read_text()
    assert pc.shape == (n, 6) and "device: cpu" in opts
    return pc


def test_four_clis_write_result_and_opts(tmp_path, hand):
    io.export_pc(scramble_signs(hand, seed=9)[0], tmp_path / "in.xyz")
    common = ["--pc", str(tmp_path / "in.xyz"), "--models", CKPT, "--iters", "1",
              "--number_parts", "6", "--minimum_points_per_patch", "40",
              "--device", "cpu"]
    orient_pointcloud.main(common + ["--export_dir", str(tmp_path / "a"),
                                     "--propagation_iters", "1", "--diffuse"])
    orient_large.main(common + ["--export_dir", str(tmp_path / "b")])
    dipole_api.main(common + ["--export_dir", str(tmp_path / "c")])
    for d in "abc":
        assert sign_agreement(_outputs(tmp_path / d, 2000), hand) >= 0.95
    reference_orientation.main(
        ["--input", str(tmp_path / "in.xyz"),
         "--reference", str(tmp_path / "a" / "final_result.xyz"),
         "--output", str(tmp_path / "d" / "final_result.xyz"), "--device", "cpu"])
    assert sign_agreement(_outputs(tmp_path / "d", 2000), hand) >= 0.95
