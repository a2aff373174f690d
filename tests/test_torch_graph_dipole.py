"""The port's patch-graph pipeline (pipelines/graph_dipole.py) and its CLI
against dipole_tpu's on JAX-CPU: grid and ncut partitioning at 800 points
within 0.02 GT agreement of the JAX package, identical host helpers, the
experiment drivers and the `run` / `folder` subcommands."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dipole_tpu.pipelines import graph_dipole as jgd
from dipole_tpu_torch.cli import graph_dipole as cli
from dipole_tpu_torch.ops.metrics import sign_agreement
from dipole_tpu_torch.pipelines import graph_dipole as gd
from dipole_tpu_torch.utils.io import load_point_cloud, write_ply
from tests.conftest import make_sphere, scramble_signs

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("method,kw", [
    ("grid_partition", dict(n_part=4, min_patch=0)),
    ("ncut_partition", dict(k_neighbors=10, mininum_rate=0.15)),
])
def test_graph_dipole_core_near_jax(method, kw):
    gt = make_sphere(800, seed=90, noise=0.005)
    scr, _ = scramble_signs(gt, seed=91)
    out, G, patches, flip = gd.graph_dipole_core(scr.copy(), divide_method=method,
                                                 device="cpu", **kw)
    want, Gj, patches_j, _ = jgd.graph_dipole_core(scr.copy(), divide_method=method, **kw)
    assert sorted(np.concatenate(patches).tolist()) == list(range(800))
    a_t, a_j = sign_agreement(out, gt), sign_agreement(want, gt)
    assert abs(a_t - a_j) <= 0.02, (a_t, a_j)
    assert a_t >= 0.95
    assert len(G.V) == len(patches)
    if method == "grid_partition":         # the same voxel patches and edges
        assert [p.tolist() for p in patches] == [np.asarray(p).tolist() for p in patches_j]
        assert [(e.u, e.v) for e in G.E] == [(e.u, e.v) for e in Gj.E]


def test_graph_dipole_core_rejects_unknown_method():
    with pytest.raises(ValueError, match="divide method"):
        gd.graph_dipole_core(make_sphere(50, seed=92), divide_method="x", device="cpu")


def test_host_helpers_match_jax():
    pc = make_sphere(600, seed=93)
    assert gd.avg_min_dist(pc, 10) == jgd.avg_min_dist(pc, 10)
    a, b = pc[:300], pc[300:]
    assert gd.if_pc_neighbor(a, b, 0.1) == jgd.if_pc_neighbor(a, b, 0.1)
    assert gd.if_pc_neighbor(a, b + 10, 0.1) is False
    labels = gd.bitree_cluster(pc[:, :3], k_neighbors=10, minimum_rate=0.2)
    assert labels.shape == (600,) and np.bincount(labels).min() > 0
    assert len(np.bincount(labels)) >= 4


def test_server_api_and_file_wrappers(tmp_path):
    gt = make_sphere(500, seed=94, noise=0.003) * np.float32(0.3)
    gt[:, 3:] /= np.linalg.norm(gt[:, 3:], axis=1, keepdims=True)
    cfg = {"max_nn": 30, "divide_method": "grid_partition", "n_part": 3, "min_patch": 0}
    out = gd.graph_dipole_server_api(gt[:, :3], cfg, device="cpu")
    assert out.shape == (500, 6) and sign_agreement(out, gt) >= 0.95
    scr, _ = scramble_signs(gt, seed=95)
    for fn in (gd.st_propagation_points_file, gd.xie_propagation_points_file):
        got = fn(scr, device="cpu")
        want = getattr(jgd, fn.__name__)(scr)
        np.testing.assert_array_equal(np.sign(got[:, 3:]), np.sign(want[:, 3:]))
    got = gd.xie_tree_propagation_points_file(scr, times=3, device="cpu")
    want = jgd.xie_tree_propagation_points_file(scr, times=3)
    np.testing.assert_array_equal(np.sign(got[:, 3:]), np.sign(want[:, 3:]))


def test_experiment_drivers(tmp_path):
    gt = make_sphere(300, seed=96) * np.float32(0.05)
    gt[:, 3:] = make_sphere(300, seed=96)[:, 3:]
    scr, _ = scramble_signs(gt, seed=97)
    write_ply(tmp_path / "a_gt.ply", gt[:, :3], gt[:, 3:])
    write_ply(tmp_path / "a_res.ply", scr[:, :3], scr[:, 3:])
    m = gd.single_propagate_file(tmp_path / "a_res.ply", use_origin_normal=True,
                                 gt_path=tmp_path / "a_gt.ply", device="cpu")
    mj = jgd.single_propagate_file(tmp_path / "a_res.ply", use_origin_normal=True,
                                   gt_path=tmp_path / "a_gt.ply")
    assert m == mj
    row, head = gd.run_res_and_compare(str(tmp_path / "a_gt.ply"), device="cpu")
    assert head == "filename,origin_loss,tree_xie_loss,xie_loss,dipole_loss"
    assert row.split(",")[0].endswith("a_gt.ply") and len(row.split(",")) == 5
    row, head = gd.run_file(str(tmp_path / "a_gt.ply"), device="cpu")
    assert head == "filename,tree_xie_loss" and len(row.split(",")) == 2


def test_cli_run_on_a_small_ply(tmp_path):
    gt = make_sphere(900, seed=98, noise=0.003)
    write_ply(tmp_path / "s.ply", gt[:, :3], gt[:, 3:])
    r = subprocess.run([sys.executable, "-m", "dipole_tpu_torch.cli.graph_dipole",
                        "run", "--pc", str(tmp_path / "s.ply"), "--verbose",
                        "--output", str(tmp_path / "out"), "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "finished: build patch graph + rectify" in r.stdout
    assert "flip acc" in r.stdout and "metrics:" in r.stdout
    out = load_point_cloud(tmp_path / "out" / "final_result.ply")
    assert out.shape == (900, 6) and sign_agreement(out, gt) >= 0.95


def test_cli_main_returns_metrics_and_stages(tmp_path):
    from dipole_tpu_torch.utils.timing import timer_factory

    gt = make_sphere(700, seed=99)
    write_ply(tmp_path / "s.ply", gt[:, :3], gt[:, 3:])
    timer = timer_factory()
    m = cli.main(["run", "--pc", str(tmp_path / "s.ply"), "--device", "cpu"], timer=timer)
    assert m["total_count"] == 700 and m["count_90"] <= 0.05 * 700
    assert "build patch graph + rectify" in timer.stages


def test_cli_folder_writes_csv(tmp_path):
    gt = make_sphere(250, seed=100) * np.float32(0.02)
    gt[:, 3:] = make_sphere(250, seed=100)[:, 3:]
    (tmp_path / "d").mkdir()
    write_ply(tmp_path / "d" / "a.ply", gt[:, :3], gt[:, 3:])
    cli.main(["folder", "--folder", str(tmp_path / "d"), "--exp_name", "e1",
              "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])
    lines = (tmp_path / "logs" / "e1.csv").read_text().strip().split("\n")
    assert lines[0] == "filename,tree_xie_loss" and len(lines) == 2


def test_cli_flags_match_jax_plus_device():
    from dipole_tpu.cli import graph_dipole as jcli

    for argv in (["run", "--pc", "x.ply"],
                 ["folder", "--folder", "d", "--exp_name", "e"]):
        got = vars(cli.get_parser().parse_args(argv))
        want = vars(jcli.get_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
