"""3D wind-field visualization and VTK export (the port's copy of
``gan_sr_wind_field_tpu/viz/field3d.py``).

Counterpart of the reference's mayavi scenes and tvtk structured grids
(plot_data.py:95-157,951-972,1422-1507). mayavi needs a GUI stack that a
headless host does not have, so:

- `plot_field_3d` / `plot_scalar_3d` render matplotlib (Agg) 3D scenes —
  quiver over a terrain surface, and z-slice stacks — for quick looks and
  TB figures.
- `export_vtk_structured_grid` writes a *legacy ASCII VTK* STRUCTURED_GRID
  file with no external dependency; open in ParaView/VisIt for the full
  interactive 3D experience the thesis used mayavi for.

All functions take channel-last (nx, ny, nz[, C]) arrays and the physical
coordinate axes/heights. Matplotlib is imported inside the plotting
functions (Agg), not with the module, so the VTK export and the rest of the
package import without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend (unless one is set)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _mesh_xyz(x, y, z):
    """x (nx,), y (ny,), z (nx,ny,nz) → broadcast 3D coordinate arrays."""
    nx, ny, nz = z.shape
    xx = np.broadcast_to(np.asarray(x)[:, None, None], (nx, ny, nz))
    yy = np.broadcast_to(np.asarray(y)[None, :, None], (nx, ny, nz))
    return xx, yy, np.asarray(z)


def plot_field_3d(
    x,
    y,
    z,
    uvw,
    terrain: Optional[np.ndarray] = None,
    stride: int = 4,
    z_stride: int = 2,
    title: str = "wind field",
):
    """3D quiver of (u,v,w) over an optional terrain surface → Figure.

    ``stride``/``z_stride`` thin the arrows (mayavi's mask_points
    equivalent). Arrow colour = wind speed.
    """
    plt = _pyplot()
    xx, yy, zz = _mesh_xyz(x, y, z)
    s = np.s_[::stride, ::stride, ::z_stride]
    u, v, w = uvw[..., 0][s], uvw[..., 1][s], uvw[..., 2][s]
    speed = np.sqrt(u**2 + v**2 + w**2)

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    if terrain is not None:
        xs = np.broadcast_to(np.asarray(x)[:, None], terrain.shape)
        ys = np.broadcast_to(np.asarray(y)[None, :], terrain.shape)
        ax.plot_surface(
            xs, ys, terrain, cmap="gist_earth", alpha=0.6, linewidth=0
        )
    norm = plt.Normalize(speed.min(), speed.max() + 1e-9)
    colors = plt.cm.viridis(norm(speed.ravel()))
    ax.quiver(
        xx[s].ravel(), yy[s].ravel(), zz[s].ravel(),
        u.ravel(), v.ravel(), w.ravel(),
        length=float(np.mean(np.diff(np.asarray(x)))) * stride * 0.8,
        normalize=True, colors=colors, linewidth=0.7,
    )
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    fig.colorbar(
        plt.cm.ScalarMappable(norm=norm, cmap="viridis"),
        ax=ax, shrink=0.6, label="|u| [m/s]",
    )
    return fig


def plot_scalar_3d(x, y, z, scalar, n_slices: int = 4, title: str = "scalar"):
    """Stack of semi-transparent z-level pcolor slices → Figure
    (the matplotlib stand-in for mayavi volume rendering)."""
    plt = _pyplot()
    nx, ny, nz = scalar.shape
    xx = np.broadcast_to(np.asarray(x)[:, None], (nx, ny))
    yy = np.broadcast_to(np.asarray(y)[None, :], (nx, ny))
    idxs = np.linspace(0, nz - 1, min(n_slices, nz)).astype(int)
    vmin, vmax = float(scalar.min()), float(scalar.max() + 1e-9)

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    for k in idxs:
        ax.plot_surface(
            xx, yy, z[..., k],
            facecolors=plt.cm.inferno((scalar[..., k] - vmin) / (vmax - vmin)),
            alpha=0.45, linewidth=0, shade=False,
        )
    ax.set_title(title)
    fig.colorbar(
        plt.cm.ScalarMappable(
            norm=plt.Normalize(vmin, vmax), cmap="inferno"
        ),
        ax=ax, shrink=0.6,
    )
    return fig


def export_vtk_structured_grid(
    path: str,
    x,
    y,
    z,
    vectors: Optional[Dict[str, np.ndarray]] = None,
    scalars: Optional[Dict[str, np.ndarray]] = None,
    comment: str = "gan_sr_wind_field_tpu_torch field export",
) -> str:
    """Write a legacy ASCII VTK STRUCTURED_GRID file (ParaView-compatible).

    x (nx,), y (ny,), z (nx, ny, nz) physical heights; ``vectors`` maps
    name → (nx, ny, nz, 3); ``scalars`` maps name → (nx, ny, nz).
    Returns the written path. No VTK/tvtk dependency — the format is plain
    text (VTK file formats spec, legacy structured grid).
    """
    z = np.asarray(z, np.float32)
    nx, ny, nz = z.shape
    xx, yy, zz = _mesh_xyz(x, y, z)
    npts = nx * ny * nz

    def _pt_order(a):  # VTK wants x fastest, then y, then z
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0))).reshape(-1)

    if not path.endswith(".vtk"):
        path = path + ".vtk"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(comment[:255] + "\n")
        f.write("ASCII\nDATASET STRUCTURED_GRID\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n")
        f.write(f"POINTS {npts} float\n")
        pts = np.stack(
            [_pt_order(xx), _pt_order(yy), _pt_order(zz)], axis=-1
        )
        np.savetxt(f, pts, fmt="%.6g")
        f.write(f"POINT_DATA {npts}\n")
        for name, vec in (vectors or {}).items():
            f.write(f"VECTORS {name} float\n")
            comp = np.stack(
                [_pt_order(vec[..., c]) for c in range(3)], axis=-1
            )
            np.savetxt(f, comp, fmt="%.6g")
        for name, sc in (scalars or {}).items():
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, _pt_order(np.asarray(sc, np.float32)), fmt="%.6g")
    return path
