"""HARMONIE-SIMRA raw files → the hourly-sample cache (the port's own copy
of ``gan_sr_wind_field_tpu/data/downloader.py``: the same files, names and
bookkeeping for the same raw inputs).

Counterpart of the reference downloader (download_data.py:20-255,403-540):
two .nc simulations per day (T00Z/T12Z, 13 timesteps each, last dropped →
24 hourly samples/day) from
``https://thredds.met.no/thredds/fileServer/opwind/YYYY/MM/DD/``, variables
``x_wind_ml``, ``y_wind_ml``, ``upward_air_velocity_ml``, ``air_pressure_ml``,
``geopotential_height_ml`` laid out (t, z, x, y), transposed to (t, x, y, z)
with z *reversed* (index 0 = ground), cropped x 4:-4, y 4:-3, z 1:1+nz,
NaN/inf/outlier filtered, and written as one pickle per hour plus per-hour
max stats.

Everything but the fetch works offline on raw files already under
``<data_root>/downloaded_raw_bessaker_data/``: the network is reached only
for a raw file that is absent there and not yet listed invalid. Files are
read with ``netCDF4`` where it is installed, else with scipy's netCDF3
classic reader. Needs numpy and scipy, no torch.
"""

from __future__ import annotations

import logging
import os
from datetime import date, timedelta
from typing import List, Optional, Tuple

import numpy as np

from gan_sr_wind_field_tpu_torch.data import files as dfiles

BASE_URL = "https://thredds.met.no/thredds/fileServer/opwind/"
DATA_CODE = "simra_BESSAKER_"
SIM_TIMES = ("T00Z.nc", "T12Z.nc")

# reference crop of the raw grids (download_data.py:258-262):
X_SLICE = slice(4, -4)
Y_SLICE = slice(4, -3)


def nc_url(day: date, sim_time: str) -> str:
    """URL of one raw simulation file (download_data.py:48-74)."""
    name = f"{DATA_CODE}{day.strftime('%Y%m%d')}{sim_time}"
    return f"{BASE_URL}{day.year}/{day.month:02d}/{day.day:02d}/{name}"


def raw_filename(day: date, sim_time: str) -> str:
    return f"{DATA_CODE}{day.strftime('%Y%m%d')}{sim_time}"


def sample_is_invalid(z, zag, u, v, w, p) -> bool:
    """Reference validity filter (download_data.py:423-452): NaN/inf
    anywhere, wind components > 100 m/s, or pressure > 2e5 Pa."""
    for a in (z, zag, u, v, w, p):
        if not np.all(np.isfinite(a)):
            return True
    if max(np.max(u), np.max(v), np.max(w)) > 100.0:
        return True
    if np.max(p) > 2e5:
        return True
    return False


class _ScipyNC:
    """netCDF3-classic reader shim over scipy.io.netcdf_file exposing the
    same ``fid[key][:]`` / ``close()`` surface as netCDF4.Dataset.
    ``maskandscale=True`` gives netCDF4's automatic CF handling (mask
    _FillValue/missing_value — incl. NaN fills — then apply
    scale_factor/add_offset)."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file

        self._f = netcdf_file(path, "r", mmap=False, maskandscale=True)

    def __getitem__(self, key):
        return self._f.variables[key]

    def close(self) -> None:
        self._f.close()


def open_nc(path: str):
    """Open a raw simulation file: netCDF4 if available (HDF5-backed
    files), else scipy's netCDF3-classic reader."""
    try:
        import netCDF4  # looked up at call time: an optional dependency
    except ImportError:
        return _ScipyNC(path)
    return netCDF4.Dataset(path, mode="r")


def _read_var(nc_fid, key, z_slice):
    """(t, z, x, y), masked where filled → (t, x, y, z) float64 with z
    reversed (ground first), last timestep dropped, fills as NaN, the
    reference crop applied."""
    arr = np.transpose(nc_fid[key][:], (0, 2, 3, 1))[:-1, :, :, ::-1]
    arr = np.ma.filled(arr.astype(float), np.nan)
    return arr[:, X_SLICE, Y_SLICE, z_slice]


def extract_hourly_samples(
    nc_fid, number_of_z_layers: int
) -> Tuple[np.ndarray, ...]:
    """One open netCDF Dataset → (z, u, v, w, p) stacks of 12 hourly
    (nx, ny, nz) samples. z crop starts at level 1 like the reference
    (download_data.py:262)."""
    z_slice = slice(1, 1 + number_of_z_layers)
    z = _read_var(nc_fid, "geopotential_height_ml", z_slice)
    u = _read_var(nc_fid, "x_wind_ml", z_slice)
    v = _read_var(nc_fid, "y_wind_ml", z_slice)
    w = _read_var(nc_fid, "upward_air_velocity_ml", z_slice)
    p = _read_var(nc_fid, "air_pressure_ml", z_slice)
    return z, u, v, w, p


def _hour_names(day: date, sim_time: str) -> List[str]:
    base = 0 if sim_time == "T00Z.nc" else 12
    return [f"{day.isoformat()}-{base + h:02d}.pkl" for h in range(12)]


def download_dataset(
    data_root: str,
    start_date: date,
    end_date: date,
    number_of_z_layers: int = 10,
    subfolder: Optional[str] = None,
) -> List[str]:
    """Split the date range's raw files into the hourly-sample cache,
    fetching a raw file only where it is absent.

    Tolerates missing remote files (tracked in ``invalid_files.txt`` like
    download_data.py:88-92) and skips already-cached hours. Returns the list
    of valid cached sample names.
    """
    from urllib import request

    log = logging.getLogger("status")
    raw_dir = os.path.join(data_root, "downloaded_raw_bessaker_data")
    os.makedirs(raw_dir, exist_ok=True)
    sub = subfolder or f"bessaker_z{number_of_z_layers}"
    folder = dfiles.dataset_folder(data_root, sub)
    os.makedirs(dfiles.max_stats_dir(folder), exist_ok=True)

    invalid_path = os.path.join(raw_dir, "invalid_files.txt")
    invalid = set()
    if os.path.isfile(invalid_path):
        invalid = {line.strip() for line in open(invalid_path)}

    # Hours rejected by the validity filter are remembered here so a
    # simulation with some filtered hours still counts as fully processed
    # (otherwise its raw .nc would be re-parsed on every call). Lives in
    # the z-config-specific dataset folder, NOT the shared raw_dir:
    # validity is judged on the z-cropped arrays, so an hour invalid at
    # z10 can be perfectly valid at z3.
    filtered_path = os.path.join(folder, "filtered_samples.txt")
    filtered = set()
    if os.path.isfile(filtered_path):
        filtered = {line.strip() for line in open(filtered_path)}

    valid_names: List[str] = []
    static_done = os.path.isfile(
        dfiles.static_path(os.path.join(data_root, "full_dataset_files"))
    )
    day = start_date
    while day <= end_date:
        for sim_time in SIM_TIMES:
            names = _hour_names(day, sim_time)
            if all(
                n in filtered
                or os.path.isfile(dfiles.sample_path(folder, n))
                for n in names
            ):
                valid_names.extend(n for n in names if n not in filtered)
                continue
            fname = raw_filename(day, sim_time)
            if fname in invalid:
                continue
            local = os.path.join(raw_dir, fname)
            if not os.path.isfile(local):
                url = nc_url(day, sim_time)
                try:
                    request.urlretrieve(url, local)
                    log.info(f"downloaded {fname}")
                except Exception as e:
                    log.warning(f"missing remote file {url}: {e}")
                    with open(invalid_path, "a") as f:
                        f.write(fname + "\n")
                    invalid.add(fname)
                    continue
            try:
                nc_fid = open_nc(local)
                try:
                    if not static_done:  # first file that actually opens
                        _extract_static(nc_fid, data_root)
                        static_done = True
                    z, u, v, w, p = extract_hourly_samples(
                        nc_fid, number_of_z_layers
                    )
                finally:
                    nc_fid.close()
            except Exception as e:
                log.warning(f"corrupt file {local}: {e}")
                with open(invalid_path, "a") as f:
                    f.write(fname + "\n")
                invalid.add(fname)
                continue

            terrain, _, _ = dfiles.read_static(
                os.path.join(data_root, "full_dataset_files")
            )
            zag = z - terrain[None, :, :, None]
            for t, name in enumerate(names):
                if sample_is_invalid(
                    z[t], zag[t], u[t], v[t], w[t], p[t]
                ):
                    log.warning(f"filtered invalid sample {name}")
                    if name not in filtered:
                        with open(filtered_path, "a") as f:
                            f.write(name + "\n")
                        filtered.add(name)
                    continue
                dfiles.write_sample(
                    folder, name, z[t], zag[t], u[t], v[t], w[t], p[t]
                )
                dfiles.write_max_stats(
                    folder, name, z[t], zag[t], u[t], v[t], w[t], p[t]
                )
                valid_names.append(name)
        day += timedelta(days=1)
    return valid_names


def _extract_static(nc_fid, data_root: str) -> None:
    """Terrain + physical x/y coordinate axes (×1e5 like the reference,
    download_data.py:143-157), reference crop applied."""
    x = 1e5 * np.asarray(nc_fid["x"][:], float)[X_SLICE]
    y = 1e5 * np.asarray(nc_fid["y"][:], float)[Y_SLICE]
    terrain = np.ma.filled(
        np.asarray(nc_fid["surface_altitude"][:]).astype(float), np.nan
    )[X_SLICE, Y_SLICE]
    dfiles.write_static(
        os.path.join(data_root, "full_dataset_files"), terrain, x, y
    )
