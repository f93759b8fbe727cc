"""On-disk sample-cache layout (the port's own copy of
``gan_sr_wind_field_tpu/data/files.py``: both packages read and write the
same files, so a cache one writes, the other reads).

Mirrors the reference's cache structure (download_data.py:99-133,
process_data.py:76-106): one pickle per hourly sample holding
``[z, z_above_ground, u, v, w, pressure]`` (each (nx, ny, nz)), a per-file
min/max stats pickle under ``max/``, a ``norm_factors.pkl`` with the
train-split aggregates, and a ``static_terrain_x_y.pkl`` with the terrain and
coordinate axes.

Layout under ``<data_root>``::

    full_dataset_files/<subfolder>/<YYYY-MM-DD-HH>.pkl
    full_dataset_files/<subfolder>/max/max_<YYYY-MM-DD-HH>.pkl
    full_dataset_files/<subfolder>/norm_factors.pkl
    full_dataset_files/<subfolder>/static_terrain_x_y.pkl   (synthetic)
    full_dataset_files/static_terrain_x_y.pkl               (real data)
    interpolated_z_data/<subfolder>/<name>.pkl              (z-interp cache)
"""

from __future__ import annotations

import os
import pickle
from datetime import date, datetime, timedelta
from typing import List, Sequence, Tuple

import numpy as np


def filenames_from_dates(start_date: date, end_date: date) -> List[str]:
    """Hourly sample names, 24 per day inclusive of both end dates.

    Format matches the reference (download_data.py:29-41):
    ``str(datetime)`` with " "→"-" and ":00:00"→"" → ``2018-03-01-00.pkl``.
    """
    t0 = datetime(start_date.year, start_date.month, start_date.day)
    t1 = datetime(end_date.year, end_date.month, end_date.day)
    hours = ((t1 - t0).days + 1) * 24
    return [
        (str(t0 + timedelta(hours=i)) + ".pkl")
        .replace(" ", "-")
        .replace(":00:00", "")
        for i in range(hours)
    ]


def dataset_folder(data_root: str, subfolder: str) -> str:
    return os.path.join(data_root, "full_dataset_files", subfolder)


def interp_cache_folder(data_root: str, subfolder: str) -> str:
    return os.path.join(data_root, "interpolated_z_data", subfolder)


def max_stats_dir(folder: str) -> str:
    return os.path.join(folder, "max")


def sample_path(folder: str, name: str) -> str:
    if not name.endswith(".pkl"):
        name = name + ".pkl"
    return os.path.join(folder, name)


def max_stats_path(folder: str, name: str) -> str:
    if not name.endswith(".pkl"):
        name = name + ".pkl"
    return os.path.join(folder, "max", "max_" + name)


def read_sample(folder: str, name: str) -> Tuple[np.ndarray, ...]:
    """→ (z, z_above_ground, u, v, w, pressure), each (nx, ny, nz)."""
    with open(sample_path(folder, name), "rb") as f:
        z, zag, u, v, w, p = pickle.load(f)
    return z, zag, u, v, w, p


def write_sample(folder: str, name: str, z, zag, u, v, w, p) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(sample_path(folder, name), "wb") as f:
        pickle.dump([z, zag, u, v, w, p], f)


def read_max_stats(folder: str, name: str):
    """→ (z_min, z_max, z_above_ground_max, uvw_max, p_min, p_max) — the
    reference's per-file stat tuple order (process_data.py:348-358)."""
    with open(max_stats_path(folder, name), "rb") as f:
        return pickle.load(f)


def write_max_stats(folder: str, name: str, z, zag, u, v, w, p) -> None:
    os.makedirs(max_stats_dir(folder), exist_ok=True)
    # uvw_max is the SIGNED max like the reference's
    # np.max(concatenate((u, v, w))) (download_data.py:474) — NOT max |.| —
    # so caches built here normalize identically to reference-built caches
    # (and imported reference .pth checkpoints see the same input scale).
    stats = (
        float(np.min(z)),
        float(np.max(z)),
        float(np.max(zag)),
        float(max(np.max(u), np.max(v), np.max(w))),
        float(np.min(p)),
        float(np.max(p)),
    )
    with open(max_stats_path(folder, name), "wb") as f:
        pickle.dump(stats, f)


def norm_factors_path(folder: str) -> str:
    return os.path.join(folder, "norm_factors.pkl")


def write_norm_factors(folder: str, stats) -> None:
    """Persist the aggregated normalization factors in the reference's list
    order [Z_MIN, Z_MAX, Z_ABOVE_GROUND_MAX, UVW_MAX, P_MIN, P_MAX]
    (process_data.py:88-106)."""
    os.makedirs(folder, exist_ok=True)
    with open(norm_factors_path(folder), "wb") as f:
        pickle.dump(
            [
                stats.z_min,
                stats.z_max,
                stats.z_above_ground_max,
                stats.uvw_max,
                stats.p_min,
                stats.p_max,
            ],
            f,
        )


def static_path(folder: str) -> str:
    return os.path.join(folder, "static_terrain_x_y.pkl")


def write_static(folder: str, terrain, x, y) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(static_path(folder), "wb") as f:
        pickle.dump([terrain, x, y], f)


def read_static(*folders: str):
    """→ (terrain, x, y) from the first folder that has the static pickle."""
    for folder in folders:
        p = static_path(folder)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                terrain, x, y = pickle.load(f)
            return np.asarray(terrain), np.asarray(x), np.asarray(y)
    raise FileNotFoundError(
        f"static_terrain_x_y.pkl not found in any of {folders}"
    )


def existing(folder: str, names: Sequence[str]) -> List[str]:
    return [n for n in names if os.path.isfile(sample_path(folder, n))]
