"""Field / graph visualization exports — the port of dipole_tpu/vis.py
(reference C43, SURVEY §2.1).

Self-contained replacements for the reference's visualization helpers,
writing .ply files (no Open3D/plotly/skimage dependency):
  - draw_pc            (reference util.py:9-23)  cloud + normals (+labels)
  - draw_field         (reference field_utils.py:472-501)  field vectors as
                       normals on target points, colored target/source
  - draw_topology      (reference util.py:346-395, graph.py:20-118)  patch
                       graph as sphere/arrow triangle meshes
  - field_cross_section (reference vis_field.py plot_F analog) samples the
                       potential/field on a planar lattice and exports a
                       colored cloud for external plotting

The meshes and clouds are numpy, written by utils/io.write_ply and
write_triangle_mesh byte for byte as the JAX package writes them. The
lattices (draw_field_isosurface, plot_cross_section, plot_isosurface,
field_cross_section) go through fields.potential and fields.field_grad on
`device` (default "cuda": csrc/potential.cu and csrc/field.cu). matplotlib
is imported only by the two plot functions, which write the .ply export
instead where it is missing.
"""
from __future__ import annotations

import numpy as np

from dipole_tpu_torch.device import as_f32, resolve_device
from dipole_tpu_torch.utils.io import write_ply

__all__ = ["draw_pc", "draw_field", "draw_topology", "field_cross_section",
           "plot_cross_section", "plot_isosurface",
           "sphere_mesh", "arrow_mesh", "write_triangle_mesh",
           "isosurface", "draw_field_isosurface"]


def draw_pc(pc, path, labels=None):
    """Write a cloud (+normals) as .ply; optional per-point labels get a
    random color per label (reference util.py:9-23)."""
    pc = np.asarray(pc)
    colors = None
    if labels is not None:
        labels = np.asarray(labels)
        rng = np.random.default_rng(0)
        palette = {lb: rng.random(3) for lb in np.unique(labels)}
        colors = np.stack([palette[lb] for lb in labels])
    normals = pc[:, 3:6] if pc.shape[1] >= 6 else None
    write_ply(path, pc[:, :3], normals, colors)


def draw_field(source, target, field_calculator, path, *args, device="cuda",
               **kwargs):
    """Evaluate a field at target points and export targets (green, field as
    normal) + sources (red) — reference field_utils.draw_field (:472-501).
    field_calculator (fields.field_grad, say) takes the float32 sources and
    target xyz as tensors on `device` and returns a tensor or an array."""
    source = np.asarray(source, np.float32)
    target = np.asarray(target, np.float32)
    dev = resolve_device(device)
    field = _host(field_calculator(as_f32(source, dev), as_f32(target[:, :3], dev),
                                   *args, **kwargs))
    if field.ndim == 3:  # per-pair fields (xie): sum over sources
        field = field.sum(axis=1)
    pts = np.concatenate([target[:, :3], source[:, :3]], axis=0)
    normals = np.concatenate(
        [field, source[:, 3:6] if source.shape[1] >= 6 else np.zeros_like(source[:, :3])],
        axis=0,
    )
    colors = np.zeros((len(pts), 3))
    colors[: len(target), 1] = 1.0
    colors[len(target):, 0] = 1.0
    write_ply(path, pts, normals, colors)


def _host(x) -> np.ndarray:
    """A numpy array of x, a tensor on any device or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _lattice(pc, grid: np.ndarray, quantity: str, device) -> np.ndarray:
    """The potential phi (T,) of cloud pc (N, 6) at the lattice points grid
    (T, 3), or its field E (T, 3) for any other quantity, float32 on the
    host; the kernel runs on `device`."""
    from dipole_tpu_torch.ops import fields

    dev = resolve_device(device)
    src = as_f32(np.asarray(pc, np.float32), dev)
    tgt = as_f32(grid, dev)
    if quantity == "potential":
        return fields.potential(src, tgt).cpu().numpy()
    return fields.field_grad(src, tgt).cpu().numpy()


def sphere_mesh(center, radius=0.008, n=10, m=10):
    """Lat-long sphere triangle mesh (reference graph.py:102-118)."""
    verts, faces = [], []
    for i in range(n):
        for j in range(m):
            theta = 2 * np.pi * i / n
            phi = np.pi * j / m
            verts.append(center + radius * np.array([
                np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                np.cos(phi)]))
    for i in range(n):
        for j in range(m):
            a = i * m + j
            b = i * m + (j + 1) % m
            c = ((i + 1) % n) * m + j
            d = ((i + 1) % n) * m + (j + 1) % m
            faces.append([a, b, c])
            faces.append([b, d, c])
    return np.asarray(verts), np.asarray(faces)


def arrow_mesh(start, end, radius=0.001, n=10):
    """Cylinder+cone arrow mesh (reference graph.py:46-91)."""
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    d = end - start
    z = d / (np.linalg.norm(d) + 1e-12)
    x = np.array([1.0, 0, 0])
    if np.linalg.norm(x - z) < 0.01:
        x = np.array([0, 1.0, 0])
    y = np.cross(z, x)
    y /= np.linalg.norm(y) + 1e-12
    x = np.cross(y, z)
    x /= np.linalg.norm(x) + 1e-12
    end2 = start + d * 0.95
    start2 = start + d * 0.05
    cyl_end = start2 + (end2 - start2) * 0.9
    verts, faces = [], []
    for ring_c, r in [(start2, radius / 2), (cyl_end, radius / 2)]:
        for i in range(n):
            t = 2 * np.pi * i / n
            verts.append(ring_c + r * (np.cos(t) * x + np.sin(t) * y))
    for i in range(n):
        faces.append([n + i, i, (i + 1) % n])
        faces.append([n + i, (i + 1) % n, (i + 1) % n + n])
    base = len(verts)
    for i in range(n):
        t = 2 * np.pi * i / n
        verts.append(cyl_end + radius * (np.cos(t) * x + np.sin(t) * y))
    verts.append(end2)
    tip = len(verts) - 1
    for i in range(n):
        faces.append([tip, base + i, base + (i + 1) % n])
    return np.asarray(verts), np.asarray(faces)


def write_triangle_mesh(path, verts, faces, colors=None):
    """Minimal binary PLY triangle mesh writer."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property double x", "property double y", "property double z"]
    if colors is not None:
        colors = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        for i, v in enumerate(verts):
            f.write(np.asarray(v, "<f8").tobytes())
            if colors is not None:
                f.write(colors[i].tobytes())
        counts = np.full((len(faces), 1), 3, np.uint8)
        for c, face in zip(counts, faces):
            f.write(c.tobytes())
            f.write(np.asarray(face, "<i4").tobytes())


def draw_topology(G, pc, patches, nodelabel=None, edgelabel=None, path=None):
    """Patch-graph topology as a colored sphere/arrow mesh (reference
    util.draw_topology, util.py:346-395)."""
    pc = np.asarray(pc)
    nodelabel = list(nodelabel) if nodelabel is not None else [0] * len(G.V)
    edgelabel = list(edgelabel) if edgelabel is not None else [0] * len(G.E)
    rng = np.random.default_rng(0)
    node_colors = {lb: rng.random(3) for lb in set(nodelabel)}
    edge_colors = {lb: rng.random(3) for lb in set(edgelabel)}
    if len(node_colors) == 2:
        ks = sorted(node_colors)
        node_colors = {ks[0]: np.array([1.0, 0, 0]), ks[1]: np.array([0, 1.0, 0])}
    if len(edge_colors) == 2:
        ks = sorted(edge_colors)
        edge_colors = {ks[0]: np.array([1.0, 0, 0]), ks[1]: np.array([0, 1.0, 0])}

    def center(v):
        return pc[np.asarray(patches[v]), :3].mean(axis=0)

    all_v, all_f, all_c = [], [], []

    def add(verts, faces, color):
        off = sum(len(v) for v in all_v)
        all_v.append(verts)
        all_f.append(faces + off)
        all_c.append(np.tile(color, (len(verts), 1)))

    for i in range(len(G.V)):
        v, f = sphere_mesh(center(i))
        add(v, f, node_colors[nodelabel[i]])
    for i, e in enumerate(G.E):
        v, f = arrow_mesh(center(e.u), center(e.v))
        add(v, f, edge_colors[edgelabel[i]])
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    colors = np.concatenate(all_c)
    if path is not None:
        write_triangle_mesh(path, verts, faces, colors)
    return verts, faces, colors


# ---------------------------------------------------------------------------
# Isosurface extraction (capability of reference vis_field.draw_F, :76-138)
# ---------------------------------------------------------------------------
# Marching tetrahedra: each lattice cube is split into 6 tetrahedra around
# the 0-6 diagonal; every tet contributes 0-2 triangles depending on which
# of its 4 corners sit above the level. Original implementation (the
# reference delegates to skimage.marching_cubes, unavailable here).

_CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])
_TETS = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
         (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]


def _tet_cases():
    """bits (which of the 4 tet corners are above level) -> triangle list,
    each triangle being 3 crossing edges (corner-above, corner-below)."""
    cases = {}
    for bits in range(16):
        ins = [i for i in range(4) if bits >> i & 1]
        out = [i for i in range(4) if not bits >> i & 1]
        if len(ins) == 1:
            i = ins[0]
            cases[bits] = [[(i, out[0]), (i, out[1]), (i, out[2])]]
        elif len(ins) == 3:
            o = out[0]
            cases[bits] = [[(ins[0], o), (ins[1], o), (ins[2], o)]]
        elif len(ins) == 2:
            i, j = ins
            k, l = out
            cases[bits] = [[(i, k), (i, l), (j, l)],
                           [(i, k), (j, l), (j, k)]]
        else:
            cases[bits] = []
    return cases


_CASES = _tet_cases()


def isosurface(values: np.ndarray, axes, level: float):
    """Extract the `level` isosurface of a scalar lattice.

    values: (nx, ny, nz) samples at the tensor grid of `axes` = (x, y, z)
    1-D coordinate arrays. Returns (verts (V, 3), faces (V//3, 3)) as an
    independent-triangle soup."""
    values = np.asarray(values, np.float64)
    x, y, z = (np.asarray(a, np.float64) for a in axes)
    P = np.stack(np.meshgrid(x, y, z, indexing="ij"), axis=-1)

    # gather the 8 corners of every cube: (M, 8) values, (M, 8, 3) positions
    base = np.stack(np.meshgrid(np.arange(len(x) - 1), np.arange(len(y) - 1),
                                np.arange(len(z) - 1), indexing="ij"), -1)
    base = base.reshape(-1, 1, 3) + _CUBE_CORNERS[None, :, :]  # (M, 8, 3)
    ix, iy, iz = base[..., 0], base[..., 1], base[..., 2]
    vals8 = values[ix, iy, iz]
    pos8 = P[ix, iy, iz]

    tris = []
    weights = np.array([1, 2, 4, 8])
    for tet in _TETS:
        v = vals8[:, tet]
        p = pos8[:, tet]
        bits = (v > level).astype(np.int64) @ weights
        for b, case in _CASES.items():
            if not case:
                continue
            m = bits == b
            if not m.any():
                continue
            vv, pp = v[m], p[m]
            for tri in case:
                corners = []
                for a, o in tri:
                    t = (level - vv[:, a]) / (vv[:, o] - vv[:, a])
                    corners.append(pp[:, a] + t[:, None] * (pp[:, o] - pp[:, a]))
                tris.append(np.stack(corners, axis=1))
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tris, axis=0)
    verts = soup.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces


def _level_color(t: float) -> np.ndarray:
    """Small perceptual-ish ramp (dark blue -> teal -> yellow)."""
    stops = np.array([[0.27, 0.0, 0.33], [0.13, 0.57, 0.55], [0.99, 0.9, 0.15]])
    t = float(np.clip(t, 0.0, 1.0)) * (len(stops) - 1)
    i = min(int(t), len(stops) - 2)
    f = t - i
    return stops[i] * (1 - f) + stops[i + 1] * f


def draw_field_isosurface(pc, path, res: int = 48, extent: float = 1.2,
                          levels: int = 10, quantity: str = "potential",
                          device="cuda"):
    """Sample the dipole potential (or |E|) of `pc` on a res^3 lattice and
    export `levels` nested isosurfaces as one level-colored .ply mesh — the
    capability of reference vis_field.draw_F (:76-138), as a true triangle
    mesh rather than the reference's vertex dump. The lattice runs on
    `device`.

    Returns (verts, faces, colors)."""
    lin = np.linspace(-extent, extent, res)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1).astype(np.float32)
    vals = _lattice(pc, grid, quantity, device)
    if quantity == "potential":
        vals = vals.astype(np.float64)
    else:
        vals = np.linalg.norm(vals, axis=-1)
    vals = vals / (np.abs(vals).max() + 1e-30)
    F = vals.reshape(res, res, res)

    all_v, all_f, all_c = [], [], []
    lo, hi = F.min(), F.max()
    for i, level in enumerate(np.linspace(lo, hi, levels + 2)[1:-1]):
        v, f = isosurface(F, (lin, lin, lin), float(level))
        if len(v) == 0:
            continue
        off = sum(len(a) for a in all_v)
        all_v.append(v)
        all_f.append(f + off)
        all_c.append(np.tile(_level_color((level - lo) / (hi - lo + 1e-30)),
                             (len(v), 1)))
    if not all_v:
        verts = np.zeros((0, 3))
        faces = np.zeros((0, 3), np.int32)
        colors = np.zeros((0, 3))
    else:
        verts = np.concatenate(all_v)
        faces = np.concatenate(all_f)
        colors = np.concatenate(all_c)
    if path is not None:
        write_triangle_mesh(path, verts, faces, colors)
    return verts, faces, colors


def plot_cross_section(pc, path, axis: int = 2, value: float = 0.0,
                       n: int = 128, extent: float = 1.2,
                       quantity: str = "potential", device="cuda"):
    """Figure-grade cross-section of the dipole field (the capability of
    reference vis_field.plot_F, vis_field.py:11-73): renders the scalar field
    on a plane as a PNG with the cloud's in-slab points overlaid.

    Signed potential uses a diverging two-hue map with a neutral midpoint
    (polarity: where the field flips sign is the quantity of interest);
    field magnitude |E| uses a single-hue sequential map. Requires
    matplotlib; when unavailable, falls back to the dependency-free
    field_cross_section .ply export (path's suffix switched to .ply). The
    lattice runs on `device`. Returns the path actually written."""
    try:
        import matplotlib
        if not hasattr(matplotlib, "use"):  # a stub module is "absent"
            raise ImportError("matplotlib is stubbed")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        import pathlib

        ply = pathlib.Path(path).with_suffix(".ply")
        field_cross_section(pc, ply, axis=axis, value=value, n=n,
                            extent=extent, quantity=quantity, device=device)
        return ply

    pc = np.asarray(pc, np.float32)
    lin = np.linspace(-extent, extent, n)
    a, b = np.meshgrid(lin, lin, indexing="ij")
    grid = np.zeros((n * n, 3), np.float32)
    other = [i for i in range(3) if i != axis]
    grid[:, other[0]] = a.ravel()
    grid[:, other[1]] = b.ravel()
    grid[:, axis] = value
    vals = _lattice(pc, grid, quantity, device).astype(np.float64)
    if quantity != "potential":
        vals = np.linalg.norm(vals, axis=-1)
    V = vals.reshape(n, n)

    fig, ax = plt.subplots(figsize=(6.4, 5.4), dpi=120)
    if quantity == "potential":
        scale = np.abs(vals).mean() + 1e-30
        shown = np.tanh(V / scale)
        im = ax.imshow(shown.T, origin="lower", cmap="RdBu_r",
                       vmin=-1.0, vmax=1.0,
                       extent=(-extent, extent, -extent, extent))
        label = "tanh(potential / mean|potential|)"
    else:
        im = ax.imshow(V.T, origin="lower", cmap="Blues",
                       extent=(-extent, extent, -extent, extent))
        label = "|E|"
    slab = np.abs(pc[:, axis] - value) < (2.0 * extent / n)
    if slab.any():
        ax.scatter(pc[slab, other[0]], pc[slab, other[1]], s=4,
                   c="#222222", linewidths=0, alpha=0.8)
    names = "xyz"
    ax.set_xlabel(names[other[0]])
    ax.set_ylabel(names[other[1]])
    ax.set_title(f"dipole {quantity}, {names[axis]} = {value:g}")
    fig.colorbar(im, ax=ax, label=label)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_isosurface(pc, path, res: int = 40, extent: float = 1.2,
                    levels: int = 6, quantity: str = "potential",
                    elev: float = 22.0, azim: float = -60.0, device="cuda"):
    """Figure-grade nested-isosurface rendering (the PNG analog of reference
    vis_field.plot_F's plotly isosurface): marching-tetrahedra surfaces of
    the field drawn as translucent 3D meshes. Requires matplotlib; falls
    back to the .ply mesh export when unavailable. The lattice runs on
    `device`. Returns the path actually written."""
    try:
        import matplotlib
        if not hasattr(matplotlib, "use"):  # a stub module is "absent"
            raise ImportError("matplotlib is stubbed")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    except ImportError:
        import pathlib

        ply = pathlib.Path(path).with_suffix(".ply")
        draw_field_isosurface(pc, ply, res=res, extent=extent, levels=levels,
                              quantity=quantity, device=device)
        return ply

    verts, faces, colors = draw_field_isosurface(
        pc, None, res=res, extent=extent, levels=levels, quantity=quantity,
        device=device)
    fig = plt.figure(figsize=(6.4, 6.0), dpi=120)
    ax = fig.add_subplot(projection="3d")
    if len(faces):
        tri = verts[faces]
        coll = Poly3DCollection(tri, alpha=0.25, linewidths=0)
        coll.set_facecolor(colors[faces[:, 0]])
        ax.add_collection3d(coll)
    pc = np.asarray(pc, np.float32)
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=2, c="#222222", alpha=0.6)
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-extent, extent)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(f"dipole {quantity} isosurfaces")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def field_cross_section(pc, path, axis: int = 2, value: float = 0.0,
                        n: int = 64, extent: float = 1.2, quantity="potential",
                        device="cuda"):
    """Sample the dipole potential (or |E|) on a planar lattice and export a
    diverging-colored cloud — the exportable analog of vis_field.plot_F. The
    lattice runs on `device`; returns the (n, n) values."""
    lin = np.linspace(-extent, extent, n)
    a, b = np.meshgrid(lin, lin, indexing="ij")
    grid = np.zeros((n * n, 3), np.float32)
    other = [i for i in range(3) if i != axis]
    grid[:, other[0]] = a.ravel()
    grid[:, other[1]] = b.ravel()
    grid[:, axis] = value
    vals = _lattice(pc, grid, quantity, device)
    if quantity != "potential":
        vals = np.linalg.norm(vals, axis=-1)
    v = np.tanh(vals / (np.abs(vals).mean() + 1e-9))
    colors = np.zeros((len(grid), 3))
    colors[:, 0] = np.clip(v, 0, 1)
    colors[:, 2] = np.clip(-v, 0, 1)
    write_ply(path, grid, None, colors)
    return vals.reshape(n, n)
