"""The port's vis.py and analysis.py on the CPU, against dipole_tpu's on the
same inputs: mirrors tests/test_vis_analysis.py, and adds byte-equal .ply
files from both packages' draw_pc, draw_field and draw_topology, and
field_cross_section values within 1e-5 relative of the JAX package's."""
import json
import sys
import types

import numpy as np
import pytest

from dipole_tpu import analysis as janalysis
from dipole_tpu import graphs as jgraphs
from dipole_tpu import vis as jvis
from dipole_tpu.ops import fields as jfields
from dipole_tpu_torch import analysis, graphs, vis
from dipole_tpu_torch.ops import fields
from dipole_tpu_torch.utils.io import read_ply, write_ply
from tests.conftest import make_sphere


def test_draw_pc_with_labels(tmp_path):
    pc = make_sphere(100, seed=0)
    labels = np.arange(100) % 4
    vis.draw_pc(pc, tmp_path / "a.ply", labels=labels)
    v = read_ply(tmp_path / "a.ply")
    assert len(v["x"]) == 100 and "red" in v and "nx" in v
    jvis.draw_pc(pc, tmp_path / "j.ply", labels=labels)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_draw_field(tmp_path):
    src = make_sphere(50, seed=1)
    tgt = make_sphere(30, seed=2) * 1.5
    vis.draw_field(src, tgt, fields.field_grad, tmp_path / "f.ply", device="cpu")
    v = read_ply(tmp_path / "f.ply")
    assert len(v["x"]) == 80
    # target rows carry the field as normals; source rows keep their normals
    assert (v["green"][:30] > 0).all() and (v["red"][30:] > 0).all()
    jvis.draw_field(src, tgt, jfields.field_grad, tmp_path / "jf.ply")
    w = read_ply(tmp_path / "jf.ply")
    # the field itself: tests/test_torch_fields_patch.py's port-to-JAX bound
    got = np.stack([v[k] for k in ("nx", "ny", "nz")], 1)
    want = np.stack([w[k] for k in ("nx", "ny", "nz")], 1)
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(want) + 0.1 * np.abs(want).max()))
    # one calculator for both packages: the files are the same bytes
    field = np.asarray(jfields.field_grad(src, tgt[:, :3]))
    vis.draw_field(src, tgt, lambda s, t: field, tmp_path / "a.ply", device="cpu")
    jvis.draw_field(src, tgt, lambda s, t: field, tmp_path / "b.ply")
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_draw_topology(tmp_path):
    pc = make_sphere(80, seed=3)
    patches = [np.arange(0, 40), np.arange(40, 80)]
    G = graphs.BidGraph()
    G.V = [0, 1]
    G.E = [graphs.BiEdge(0, 1, 1.0, -1.0)]
    verts, faces, colors = vis.draw_topology(G, pc, patches,
                                             path=tmp_path / "t.ply")
    assert len(verts) > 0 and len(faces) > 0
    assert (tmp_path / "t.ply").exists()
    J = jgraphs.BidGraph()
    J.V = [0, 1]
    J.E = [jgraphs.BiEdge(0, 1, 1.0, -1.0)]
    jv, jf, jc = jvis.draw_topology(J, pc, patches, path=tmp_path / "j.ply")
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("quantity", ["potential", "field"])
def test_field_cross_section(tmp_path, quantity):
    pc = make_sphere(100, seed=4) * 0.4
    vals = vis.field_cross_section(pc, tmp_path / "cs.ply", n=16,
                                   quantity=quantity, device="cpu")
    assert vals.shape == (16, 16)
    assert np.isfinite(vals).all()
    want = jvis.field_cross_section(pc, tmp_path / "j.ply", n=16, quantity=quantity)
    assert vals.dtype == want.dtype
    # 1e-5 of the largest |value| (the potential's sum cancels near 0)
    assert np.abs(vals - want).max() <= 1e-5 * np.abs(want).max()
    a, b = read_ply(tmp_path / "cs.ply"), read_ply(tmp_path / "j.ply")
    np.testing.assert_array_equal(a["x"], b["x"])


def test_analysis_get_segs(tmp_path):
    pc = make_sphere(60, seed=5)
    write_ply(tmp_path / "res0.ply", pc[:, :3], pc[:, 3:])
    write_ply(tmp_path / "res1.ply", pc[:, :3], pc[:, 3:])
    (tmp_path / "reslog.json").write_text(json.dumps({
        "node_log": [{"id": 0, "metric": 0.9}, {"id": 1, "metric": 0.8}]
    }))
    segs = analysis.get_segs(tmp_path)
    assert len(segs) == 2
    assert segs[0].metric == 0.9
    table = analysis.self_interaction_table(segs, device="cpu")
    assert len(table) == 2
    assert np.isfinite(table[0]["self_interaction_all"])
    want = janalysis.self_interaction_table(janalysis.get_segs(tmp_path))
    for got, w in zip(table, want):
        assert (got["id"], got["metric"]) == (w["id"], w["metric"])
        for k in ("self_interaction", "self_interaction_all",
                  "random_self_interaction"):
            np.testing.assert_allclose(got[k], w[k], rtol=1e-4, atol=1e-4)


def test_isosurface_sphere_analytic():
    """Marching-tetrahedra correctness: the 0.25-level set of x^2+y^2+z^2
    must be the radius-0.5 sphere, to within one lattice cell; the same
    triangles as the JAX package's."""
    lin = np.linspace(-1, 1, 33)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    F = X**2 + Y**2 + Z**2
    verts, faces = vis.isosurface(F, (lin, lin, lin), 0.25)
    assert len(verts) > 500
    assert faces.shape == (len(verts) // 3, 3)
    r = np.linalg.norm(verts, axis=1)
    spacing = lin[1] - lin[0]
    assert np.abs(r - 0.5).max() < spacing
    tri = verts.reshape(-1, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1).sum()
    assert abs(area - 4 * np.pi * 0.25) < 0.15
    jv, jf = jvis.isosurface(F, (lin, lin, lin), 0.25)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)


def test_draw_field_isosurface_writes_ply(tmp_path):
    pc = make_sphere(300, seed=3) * 0.5
    path = tmp_path / "iso.ply"
    verts, faces, colors = vis.draw_field_isosurface(pc, path, res=24, levels=6,
                                                     device="cpu")
    assert path.exists() and path.stat().st_size > 200
    assert len(verts) > 0 and len(colors) == len(verts)
    head = path.read_bytes()[:200]
    assert b"ply" in head and b"element vertex" in head
    jverts, _, _ = jvis.draw_field_isosurface(pc, None, res=24, levels=6)
    # the lattice values agree to float32 rounding: the same surfaces
    assert abs(len(verts) - len(jverts)) <= 0.01 * len(jverts)


def test_plot_cross_section_png(tmp_path):
    """plot_cross_section writes a non-empty PNG for the sphere."""
    pytest.importorskip("matplotlib")
    pc = make_sphere(80, seed=7)
    for quantity in ("potential", "field"):
        out = tmp_path / f"slice_{quantity}.png"
        got = vis.plot_cross_section(pc, out, quantity=quantity, n=32, device="cpu")
        assert got == out and out.exists() and out.stat().st_size > 1000
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_isosurface_png(tmp_path):
    pytest.importorskip("matplotlib")
    pc = make_sphere(60, seed=8)
    out = tmp_path / "iso.png"
    got = vis.plot_isosurface(pc, out, res=16, levels=3, device="cpu")
    assert got == out and out.exists() and out.stat().st_size > 1000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_write_ply(tmp_path, monkeypatch):
    """Without matplotlib (a stub module counts as absent) both plots write
    the .ply export instead, as the JAX package does."""
    monkeypatch.setitem(sys.modules, "matplotlib", types.ModuleType("matplotlib"))
    pc = make_sphere(60, seed=9)
    got = vis.plot_cross_section(pc, tmp_path / "s.png", n=16, device="cpu")
    assert got == tmp_path / "s.ply" and got.exists()
    got = vis.plot_isosurface(pc, tmp_path / "i.png", res=12, levels=2, device="cpu")
    assert got == tmp_path / "i.ply" and got.exists()
    want = jvis.plot_cross_section(pc, tmp_path / "j.png", n=16)
    assert want == tmp_path / "j.ply"
