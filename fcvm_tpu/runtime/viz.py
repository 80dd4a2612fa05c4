"""Headless result viewers: clip-plane field panels + principal-stress
glyphs (+ optional orbit GIF).

Functional equivalent of the reference's embedded pyvista viewers
(``source code/fcVM.py:1691-1989``): the ``VTK`` button's 2x2 linked
clip-plane panes (CSR / PEEQ / von Mises / triaxiality), the ``PSV``
principal-stress-vector glyph view with log scaling, and the orbital-path
GIF writer — re-designed for batch runs: static PNGs (and an optional GIF)
written next to the ``.out`` report instead of an interactive Qt window.
Host-side matplotlib only; no device work and no pyvista dependency.

Clip rendering: the kept half-space's closed surface is the set of corner
tri faces that belong to exactly one kept element (outer skin + the jagged
cut face), colored by mean nodal field value — the batch analogue of the
reference's plane-clipped unstructured grid.
"""

from __future__ import annotations

import numpy as np

# local tet corner faces (tet10 corner nodes 0-3)
_TET_FACES = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]])


def _clip_surface(coords, elnodes, normal, offset):
    """Tri faces (m, 3 node ids) forming the surface of the kept half."""
    centroids = coords[elnodes[:, :4]].mean(axis=1)
    keep = centroids @ normal <= offset
    els = elnodes[keep][:, :4]
    if len(els) == 0:
        els = elnodes[:, :4]
    faces = els[:, _TET_FACES]  # (ne_k, 4, 3)
    faces = faces.reshape(-1, 3)
    key = np.sort(faces, axis=1)
    _, idx, cnt = np.unique(
        key, axis=0, return_index=True, return_counts=True
    )
    return faces[idx[cnt == 1]]


def _render_faces(ax, coords, faces, values, cmap, title, elev=20, azim=-60):
    import matplotlib
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    verts = coords[faces]
    fvals = values[faces].mean(axis=1)
    vmin, vmax = float(np.min(values)), float(np.max(values))
    if vmax <= vmin:
        vmax = vmin + 1.0
    norm = (fvals - vmin) / (vmax - vmin)
    mapper = matplotlib.colormaps[cmap]
    coll = Poly3DCollection(
        verts, facecolors=mapper(norm), edgecolors="none", shade=False
    )
    ax.add_collection3d(coll)
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    c, r = (lo + hi) / 2, max(float((hi - lo).max()) / 2, 1e-9)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_title(f"{title}\n[{vmin:.3g}, {vmax:.3g}]", fontsize=9)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    return coll


def save_clip_views(
    path,
    coords: np.ndarray,
    elnodes: np.ndarray,
    fields: dict,
    normal=(1.0, 0.0, 0.0),
    frac: float = 0.5,
) -> None:
    """2x2 clip-plane panels of nodal fields (reference ``fcVM.py:1854-1989``).

    Args:
      fields: mapping name -> (nn,) nodal values; the first four entries are
        drawn (the reference panes: CSR, PEEQ, svm, triaxiality).
      normal/frac: clip plane ``x . n <= lo + frac * (hi - lo)``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = np.asarray(normal, dtype=float)
    n /= np.linalg.norm(n)
    proj = coords @ n
    offset = proj.min() + frac * (proj.max() - proj.min())
    faces = _clip_surface(coords, elnodes, n, offset)

    names = list(fields)[:4]
    fig = plt.figure(figsize=(11, 9))
    cmaps = ["inferno", "viridis", "plasma", "coolwarm"]
    for i, name in enumerate(names):
        ax = fig.add_subplot(2, 2, i + 1, projection="3d")
        _render_faces(ax, coords, faces, np.asarray(fields[name]),
                      cmaps[i % 4], name)
    fig.suptitle(
        f"clip plane n=({n[0]:.2g}, {n[1]:.2g}, {n[2]:.2g}) frac={frac:.2f}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_psv_glyphs(
    path,
    coords: np.ndarray,
    stress_nodal: np.ndarray,
    max_glyphs: int = 2000,
    log_scale: bool = True,
) -> None:
    """Principal-stress-vector glyph view (reference ``fcVM.py:1691-1852``).

    Draws the three principal direction vectors per node (red = tension,
    blue = compression), magnitudes log-compressed like the reference's
    log-scale slider; nodes subsampled to ``max_glyphs``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fcvm_tpu.ops.postproc import principal_stresses

    s1, s2, s3, v1, v2, v3 = principal_stresses(np.asarray(stress_nodal))
    nn = len(coords)
    step = max(1, nn // max_glyphs)
    sel = np.arange(0, nn, step)

    smax = max(float(np.max(np.abs([s1, s2, s3]))), 1e-12)
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    glyph_len = 0.03 * float(np.linalg.norm(hi - lo))

    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(projection="3d")
    for s, v in ((s1, v1), (s2, v2), (s3, v3)):
        mag = np.abs(s[sel]) / smax
        if log_scale:
            mag = np.log1p(mag * 99.0) / np.log(100.0)
        vn = v[sel] / np.maximum(np.linalg.norm(v[sel], axis=1, keepdims=True), 1e-30)
        d = vn * (mag * glyph_len)[:, None]
        col = np.where(s[sel] >= 0, 0, 1)
        for sign, color in ((0, "tab:red"), (1, "tab:blue")):
            m = col == sign
            if not m.any():
                continue
            ax.quiver(
                coords[sel][m, 0] - d[m, 0] / 2,
                coords[sel][m, 1] - d[m, 1] / 2,
                coords[sel][m, 2] - d[m, 2] / 2,
                d[m, 0], d[m, 1], d[m, 2],
                color=color, linewidth=0.6, arrow_length_ratio=0.0,
            )
    c, r = (lo + hi) / 2, max(float((hi - lo).max()) / 2, 1e-9)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_axis_off()
    ax.set_title(
        "principal stress vectors (red tension / blue compression, "
        f"{'log' if log_scale else 'linear'} scale)"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_orbit_gif(
    path,
    coords: np.ndarray,
    elnodes: np.ndarray,
    field: np.ndarray,
    name: str = "CSR",
    frames: int = 24,
    normal=(1.0, 0.0, 0.0),
    frac: float = 0.5,
) -> None:
    """Orbital-path GIF of the clipped field (reference ``fcVM.py:1800-1830``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    n = np.asarray(normal, dtype=float)
    n /= np.linalg.norm(n)
    proj = coords @ n
    offset = proj.min() + frac * (proj.max() - proj.min())
    faces = _clip_surface(coords, elnodes, n, offset)

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    _render_faces(ax, coords, faces, np.asarray(field), "inferno", name)

    def update(i):
        ax.view_init(elev=20, azim=-60 + 360.0 * i / frames)
        return ()

    anim = animation.FuncAnimation(fig, update, frames=frames)
    anim.save(path, writer=animation.PillowWriter(fps=8))
    plt.close(fig)


def save_result_views(outdir, name, model, res, params, gif: bool = False,
                      disp_scale: float | None = None):
    """Write the full headless viewer bundle for an analysis result.

    ``disp_scale`` warps the drawn geometry by the total displacement —
    the reference's interactive "Displacement Scale" TextBox applied to its
    embedded viewers (``fcVM.py:1948``: ``points = nocoord + ds * disp``;
    ``fcVM.py:1805``: ``warp_by_vector(factor=self.ds)``).  ``None`` takes
    the scale recorded from the continuation loop (``res.disp_scale``);
    the reference defaults the box to 1.0, i.e. true deformed shape.
    """
    from pathlib import Path

    from fcvm_tpu.ops import postproc
    from fcvm_tpu.runtime.vtk import _elements_per_node

    mesh = model.mesh
    noce = _elements_per_node(mesh.elnodes, mesh.n_nodes)
    stress, peeq, csr, svm, triax = postproc.map_stresses(
        params.averaged_option == "averaged", mesh.elnodes, mesh.n_nodes,
        res.sig_gp, res.peeq_gp, res.csr_gp, res.svm_gp, noce,
        params.sig_yield,
    )
    if disp_scale is None:
        disp_scale = float(getattr(res, "disp_scale", 1.0))
    coords = np.asarray(res.coords) + disp_scale * np.asarray(
        res.disp_total
    ).reshape(-1, 3)
    out = Path(outdir)
    save_clip_views(
        out / f"{name}_views.png", coords, mesh.elnodes,
        {"CSR": csr, "PEEQ": peeq, "von Mises": svm, "triaxiality": triax},
    )
    save_psv_glyphs(out / f"{name}_psv.png", coords, stress)
    if gif:
        save_orbit_gif(out / f"{name}_orbit.gif", coords, mesh.elnodes, csr)
