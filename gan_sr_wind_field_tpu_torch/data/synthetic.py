"""Analytic synthetic wind-field cache — the network-free data source (the
port's own copy of ``gan_sr_wind_field_tpu/data/synthetic.py``: the same
arrays for the same names).

Replaces the HARMONIE-SIMRA download for tests/benchmarks/smoke training
(SURVEY.md §4 test strategy): generates physically-plausible hourly samples
(streamfunction-derived, mostly divergence-free horizontal flow with
log-profile vertical shear over smooth synthetic terrain on terrain-following
z-levels) and writes them in exactly the reference cache layout
(files.py) so every downstream consumer is agnostic to the source.

Deterministic per sample name — regeneration is idempotent.

``write_raw_simulation`` lays the same fields out as one raw HARMONIE-SIMRA
simulation file (netCDF3 classic), so that the downloader's path
(``downloader.py``) runs without the network.
"""

from __future__ import annotations

import os
from datetime import date
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gan_sr_wind_field_tpu_torch.data import files as dfiles

GRID_SPACING = 150.0  # metres, ~ the Bessaker horizontal resolution


def _terrain(nx: int, ny: int) -> np.ndarray:
    """Smooth hills, 0..~250 m."""
    x = np.linspace(0, 2 * np.pi, nx)
    y = np.linspace(0, 2 * np.pi, ny)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    t = (
        120.0 * (1 + np.sin(1.3 * xx) * np.cos(0.9 * yy + 0.7))
        + 30.0 * np.sin(2.7 * xx + 1.1) * np.sin(2.2 * yy)
    )
    return np.maximum(t - t.min(), 0.0)


def _sample_fields(seed: int, nx: int, ny: int, nz: int, terrain):
    """One hour of synthetic flow: (z, zag, u, v, w, p) each (nx,ny,nz)."""
    rng = np.random.default_rng(seed)
    dx = GRID_SPACING
    x = np.arange(nx) * dx
    y = np.arange(ny) * dx
    xx, yy = np.meshgrid(x, y, indexing="ij")

    # terrain-following levels: sigma-like stretching, slightly compressed
    # over high terrain (like the raw SIMRA grid)
    top = 600.0
    sigma = (np.linspace(0.0, 1.0, nz + 1)[1:]) ** 1.3
    zag = sigma[None, None, :] * (top - 0.4 * terrain[:, :, None])
    z = zag + terrain[:, :, None]

    # horizontal flow from a streamfunction → divergence-free base field
    amp = rng.uniform(4.0, 14.0)
    a = rng.uniform(900.0, 2600.0)
    phase = rng.uniform(0, 2 * np.pi, size=4)
    psi_y = (
        np.cos(xx / a + phase[0]) * np.cos(yy / a + phase[1])
        + 0.5 * np.cos(2.3 * yy / a + phase[2])
    )
    psi_x = (
        -np.sin(xx / a + phase[0]) * np.sin(yy / a + phase[1])
        + 0.4 * np.sin(1.7 * xx / a + phase[3])
    )
    u2d = amp * psi_y  # ∂ψ/∂y
    v2d = -amp * psi_x  # -∂ψ/∂x

    # log-law vertical shear + small per-level perturbations
    z0 = 2.0
    shear = np.log1p(zag / z0) / np.log1p(top / z0)
    u = u2d[:, :, None] * shear
    v = v2d[:, :, None] * shear
    # weak terrain-induced vertical velocity decaying with height
    w = (
        0.15
        * (np.gradient(terrain, dx, axis=0) * u2d
           + np.gradient(terrain, dx, axis=1) * v2d)[:, :, None]
        * np.exp(-zag / 200.0)
    )
    u = u + rng.normal(0, 0.15, u.shape)
    v = v + rng.normal(0, 0.15, v.shape)
    w = w + rng.normal(0, 0.05, w.shape)

    # hydrostatic-ish pressure
    p = 101325.0 * np.exp(-z / 8400.0) + rng.normal(0, 5.0, z.shape)
    return z, zag, u, v, w, p


def generate_synthetic_cache(
    data_root: str,
    num_hours: int = 48,
    nx: int = 64,
    ny: int = 64,
    nz: int = 10,
    start: date = date(2018, 3, 1),
) -> Tuple[List[str], str]:
    """Populate the cache with ``num_hours`` hourly samples.

    → (sample names, subfolder name). Idempotent: existing files are kept
    (same seed → same contents).
    """
    sub = f"synthetic_{nx}_{ny}_{nz}"
    folder = dfiles.dataset_folder(data_root, sub)
    end = date.fromordinal(start.toordinal() + (num_hours - 1) // 24)
    names = dfiles.filenames_from_dates(start, end)[:num_hours]

    terrain = _terrain(nx, ny)
    x = np.arange(nx, dtype=np.float64) * GRID_SPACING
    y = np.arange(ny, dtype=np.float64) * GRID_SPACING
    if not os.path.isfile(dfiles.static_path(folder)):
        dfiles.write_static(folder, terrain, x, y)

    for i, name in enumerate(names):
        if os.path.isfile(dfiles.sample_path(folder, name)) and os.path.isfile(
            dfiles.max_stats_path(folder, name)
        ):
            continue
        z, zag, u, v, w, p = _sample_fields(1000 + i, nx, ny, nz, terrain)
        dfiles.write_sample(folder, name, z, zag, u, v, w, p)
        dfiles.write_max_stats(folder, name, z, zag, u, v, w, p)
    return names, sub


# the raw file's variables, by the cache's order (z, u, v, w, p)
RAW_FIELDS = {"geopotential_height_ml": 0, "x_wind_ml": 2, "y_wind_ml": 3,
              "upward_air_velocity_ml": 4, "air_pressure_ml": 5}
# int16 packing of a variable named in ``packed``: value = int16 * scale +
# offset, the fill value masked
PACK_SCALE, PACK_OFFSET, PACK_FILL = 1e-3, 0.5, -32767


def write_raw_simulation(path: str, nx: int, ny: int, nz: int, nt: int = 13,
                         seed: int = 0, packed: Sequence[str] = (),
                         fill: Optional[Tuple[int, str]] = None) -> None:
    """One raw simulation file as the downloader reads it: ``nt``
    timesteps of the analytic fields over ``_terrain(nx, ny)`` on ``nz``
    levels, each variable of ``RAW_FIELDS`` laid out (time, z, x, y) with
    z from the top down, float32; ``x`` and ``y`` (the axes over 1e5) and
    ``surface_altitude`` (x, y). Variables named in ``packed`` are int16
    with ``scale_factor``, ``add_offset`` and ``_FillValue``. ``fill`` =
    (timestep, variable) makes one voxel of that timestep a fill (the
    ``_FillValue`` where packed, else NaN) on the first level above the
    ground (the lowest that the downloader's crop keeps), inside its x/y
    crop."""
    from scipy.io import netcdf_file

    terrain = _terrain(nx, ny)
    steps = [_sample_fields(seed * 1000 + t, nx, ny, nz, terrain)
             for t in range(nt)]
    f = netcdf_file(path, "w")
    try:
        for name, n in (("time", nt), ("z", nz), ("x", nx), ("y", ny)):
            f.createDimension(name, n)
        for name, k in RAW_FIELDS.items():
            # (nx, ny, nz) ground first → (z, x, y) top first
            arr = np.stack([np.transpose(s[k][:, :, ::-1], (2, 0, 1))
                            for s in steps])
            if name in packed:
                q = np.round((arr - PACK_OFFSET) / PACK_SCALE)
                arr = np.clip(q, -32766, 32767).astype(np.int16)
            else:
                arr = arr.astype(np.float32)
            if fill is not None and fill[1] == name:
                arr[fill[0], nz - 2, nx // 2, ny // 2] = (
                    PACK_FILL if name in packed else np.nan)
            v = f.createVariable(name, arr.dtype.char, ("time", "z", "x",
                                                        "y"))
            v[:] = arr
            if name in packed:
                # numpy scalars: scipy stores a python float as float32
                v.scale_factor = np.float64(PACK_SCALE)
                v.add_offset = np.float64(PACK_OFFSET)
                v._FillValue = np.int16(PACK_FILL)
        for name, n in (("x", nx), ("y", ny)):
            v = f.createVariable(name, "d", (name,))
            v[:] = np.arange(n, dtype=np.float64) * GRID_SPACING / 1e5
        v = f.createVariable("surface_altitude", "d", ("x", "y"))
        v[:] = terrain
    finally:
        f.close()
