"""Port per-point propagation end to end (dipole_tpu_torch.api and its CLI)
against dipole_tpu.api / dipole_tpu.cli on JAX-CPU, plus the host layer the
port copies (io, config)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dipole_tpu_torch
from dipole_tpu import api as japi
from dipole_tpu.cli import orient_simple as jcli
from dipole_tpu.utils import config as jconfig
from dipole_tpu.utils import io as jio
from dipole_tpu_torch import api
from dipole_tpu_torch.ops.metrics import sign_agreement
from dipole_tpu_torch.utils import config, io
from dipole_tpu_torch.utils.timing import timer_factory
from tests.conftest import make_sphere, scramble_signs

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("n", [300, 700])
def test_orient_simple_6col_matches_jax(diffuse, n):
    pc, _ = scramble_signs(make_sphere(n, seed=40, noise=0.01), seed=41)
    want = japi.orient_simple(pc, diffuse=diffuse)
    got = api.orient_simple(pc, diffuse=diffuse, device="cpu")
    assert got.shape == (n, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(np.sign(got[:, 3:]), np.sign(want[:, 3:]))
    np.testing.assert_allclose(got, want, atol=1e-5)   # Transform round trip


def test_orient_simple_3col_matches_jax():
    """Estimated normals (demo-like scale: the estimator's radius 0.1 is a
    fixed reference semantic) equal up to row sign, orientation agrees."""
    gt = make_sphere(2000, seed=1)
    gt[:, :3] *= 0.4
    want = japi.orient_simple(gt[:, :3])
    got = api.orient_simple(gt[:, :3], device="cpu")
    d = np.minimum(np.abs(got[:, 3:] - want[:, 3:]).max(1),
                   np.abs(got[:, 3:] + want[:, 3:]).max(1))
    assert d.max() <= 1e-5
    same = ((got[:, 3:] * want[:, 3:]).sum(1) > 0).mean()
    assert same >= 0.999
    assert sign_agreement(got, gt) > 0.95


def test_orient_simple_stage_timer():
    timer = timer_factory()
    api.orient_simple(make_sphere(200, seed=42)[:, :3] * 0.3, timer=timer,
                      device="cpu")
    assert set(timer.stages) == {"estimate unoriented normals",
                                 "dipole propagation", "global sign fix"}
    assert timer.total() == pytest.approx(sum(timer.stages.values()))


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = make_sphere(50, seed=43)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.orient_simple(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dipole_tpu_torch.orient(pc)


def test_orient_dispatch(monkeypatch):
    gt = make_sphere(250, seed=9)
    out = dipole_tpu_torch.orient(scramble_signs(gt, seed=10)[0], device="cpu")
    assert sign_agreement(out, gt) == 1.0
    # 'auto' takes 'large' above 50k points and 'patches' with models
    seen = []
    monkeypatch.setattr(api, "orient_large", lambda p, **kw: seen.append("large"))
    monkeypatch.setattr(api, "orient_patches", lambda p, **kw: seen.append("patches"))
    api.orient(np.zeros((50_001, 6), np.float32))
    api.orient(gt, models=["m.pt"])
    api.orient(gt, method="patches")
    assert seen == ["large", "patches", "patches"]
    monkeypatch.undo()
    out = api.orient(scramble_signs(gt, seed=10)[0], method="patches",
                     number_parts=4, minimum_points_per_patch=20, iters=1,
                     device="cpu")
    assert sign_agreement(out, gt) == 1.0
    # the xie slice's methods (tests/test_torch_graphs.py holds them to JAX)
    for method in ("xie", "tree_xie", "hoppe"):
        out = api.orient(gt, method=method, device="cpu")
        assert out.shape == (250, 6) and out.dtype == np.float32
        np.testing.assert_allclose(out[:, :3], gt[:, :3], atol=1e-5)
    with pytest.raises(ValueError, match="unknown method"):
        api.orient(gt, method="nope")


@pytest.mark.parametrize("mesh", [None, 1, "1", "auto", "off"])
def test_single_device_mesh_values_run(mesh):
    gt = make_sphere(120, seed=44)
    out = api.orient_simple(gt, mesh=mesh, device="cpu")
    assert sign_agreement(out, gt) == 1.0


@pytest.mark.parametrize("mesh", [2, "4"])
def test_multi_device_mesh_raises(mesh):
    """A count above 1 is a mesh: on the CPU, that many CPU shards, whose
    sharded greedy and sign fix give the one-device output; on the card a
    count above the cards there raises ValueError, as in the JAX package."""
    pc, _ = scramble_signs(make_sphere(60, seed=45), seed=46)
    got = api.orient_simple(pc, diffuse=True, mesh=mesh, device="cpu")
    np.testing.assert_array_equal(got, api.orient_simple(pc, diffuse=True,
                                                         device="cpu"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        api.resolve_mesh(cards + int(mesh), "cuda")


@pytest.mark.parametrize("extra", [[], ["--estimate_normals"]],
                         ids=["6col", "estimate"])
def test_cli_matches_jax_cli(tmp_path, extra):
    gt = make_sphere(400, seed=46)
    gt[:, :3] *= 0.4
    io.export_pc(scramble_signs(gt, seed=47)[0], tmp_path / "in.xyz")
    r = subprocess.run(
        [sys.executable, "-m", "dipole_tpu_torch.cli.orient_simple",
         "--pc", str(tmp_path / "in.xyz"), "--export_dir", str(tmp_path / "out"),
         "--diffuse", "--device", "cpu", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "finished: dipole propagation" in r.stdout
    got = io.load_xyz(tmp_path / "out" / "final_result.xyz")
    opts = (tmp_path / "out" / "opts.txt").read_text()
    assert "device: cpu" in opts and "diffuse: True" in opts
    jopts = jconfig.get_parser().parse_args(
        ["--pc", str(tmp_path / "in.xyz"), "--export_dir",
         str(tmp_path / "jax_out"), "--diffuse", *extra])
    want = jcli.run(jopts)
    assert got.shape == want.shape == (400, 6)
    np.testing.assert_array_equal(np.sign(got[:, 3:]), np.sign(want[:, 3:]))


def test_cli_default_device_without_gpu_fails(tmp_path):
    io.export_pc(make_sphere(30, seed=48), tmp_path / "in.xyz")
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from dipole_tpu_torch.cli import orient_simple as c; "
            "c.main(sys.argv[1:])")
    r = subprocess.run([sys.executable, "-c", code, "--pc",
                        str(tmp_path / "in.xyz"), "--export_dir",
                        str(tmp_path / "out")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not (tmp_path / "out" / "final_result.xyz").exists()


def test_config_matches_jax_parser_plus_device():
    argv = ["--pc", "a.xyz", "--export_dir", "out"]
    got = vars(config.get_parser().parse_args(argv))
    want = vars(jconfig.get_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want



def test_pipeline_options_match_jax_dataclass_and_parser():
    """PipelineOptions: the JAX dataclass's fields and defaults, and every
    field the parser has equal to the port's get_parser() default (pc and
    export_dir are required there; mesh reads DIPOLE_TPU_MESH)."""
    import dataclasses

    got = dataclasses.asdict(config.PipelineOptions())
    assert got == dataclasses.asdict(jconfig.PipelineOptions())
    assert [f.name for f in dataclasses.fields(config.PipelineOptions)] == \
        [f.name for f in dataclasses.fields(jconfig.PipelineOptions)]
    parsed = vars(config.get_parser().parse_args(["--pc", "a.xyz", "--export_dir", "b"]))
    shared = [k for k in got if k in parsed and k not in ("pc", "export_dir", "mesh")]
    assert {"iters", "propagation_iters", "number_parts", "minimum_points_per_patch",
            "curvature_threshold", "n"} <= set(shared)
    for k in shared:
        assert got[k] == parsed[k], k

def test_host_io_matches_jax_package(tmp_path):
    np.testing.assert_array_equal(io.gen_grid(10), jio.gen_grid(10))
    pc = make_sphere(64, seed=49) * np.float32(3.0)
    a, ta = io.Transform.trans(pc)
    b, tb = jio.Transform.trans(pc)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta.inverse(a), tb.inverse(b))
    assert io.np2xyz_text(pc) == jio.np2xyz_text(pc)
    np.testing.assert_array_equal(io.orient_center_np(pc), jio.orient_center_np(pc))
    io.write_ply(tmp_path / "c.ply", pc[:, :3], normals=pc[:, 3:])
    np.testing.assert_array_equal(io.load_point_cloud(tmp_path / "c.ply"),
                                  jio.load_point_cloud(tmp_path / "c.ply"))
