"""PyTorch port: ``data/downloader.py`` against the JAX package on the CPU,
on the same seeded raw files at JAX's tiny raw grid (24 × 23, 5 raw
levels, 3 kept), written into separate data roots, with
``urllib.request.urlretrieve`` replaced by a function that raises (or, in
one test, copies a local file), so no test reaches the network.

- the names, URLs and constants; the validity filter on JAX's cases; the
  scipy reader's CF unpacking of a packed, filled variable;
- ``download_dataset``: the names it returns, every file it writes (each
  hour's pickle, its max stats, the static file, ``invalid_files.txt``,
  ``filtered_samples.txt``) byte for byte, for raw files of the port's
  analytic writer (an int16 wind with a fill hour, a file left out) and
  of JAX's own test writer; each cached hour also against a plain numpy
  re-extraction from its raw file;
- the three failure branches (missing remote, corrupt file, filtered
  hour), the per-z-config filter, a fetch that succeeds, and "a second
  call does no rework".
"""

import os
import shutil
import sys
import types
import urllib.request
from datetime import date

import numpy as np
import pytest

from gan_sr_wind_field_tpu.data import downloader as jdl
from gan_sr_wind_field_tpu_torch.data import downloader as pdl
from gan_sr_wind_field_tpu_torch.data import files as pfiles
from gan_sr_wind_field_tpu_torch.data.synthetic import (
    PACK_FILL,
    PACK_OFFSET,
    PACK_SCALE,
    RAW_FIELDS,
    write_raw_simulation,
)
from test_downloader_integration import _write_fake_nc

NX_RAW, NY_RAW, NZ_RAW, NZ = 24, 23, 5, 3
DAY = date(2018, 3, 7)


class NoNetwork:
    """``urlretrieve`` that raises and keeps the URLs it was asked for."""

    def __init__(self):
        self.urls = []

    def __call__(self, url, local):
        self.urls.append(url)
        raise OSError(f"no network: {url}")


@pytest.fixture()
def no_network(monkeypatch):
    fetch = NoNetwork()
    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    return fetch


def raw_dir(root):
    return os.path.join(root, "downloaded_raw_bessaker_data")


def seed_raw(root, days=(DAY,), skip=(), nz_raw=NZ_RAW, writer="port",
             fill=(5, "x_wind_ml")):
    """Raw files for ``days`` (T00Z and T12Z) under ``root``, all but the
    (day, sim_time) pairs in ``skip``; the port's writer packs x_wind_ml
    as int16 and fills ``fill`` in the first file, JAX's poisons hour 5."""
    os.makedirs(raw_dir(root), exist_ok=True)
    for d, day in enumerate(days):
        for s, stamp in enumerate(pdl.SIM_TIMES):
            if (day, stamp) in skip:
                continue
            path = os.path.join(raw_dir(root), pdl.raw_filename(day, stamp))
            first = d == 0 and s == 0
            if writer == "port":
                write_raw_simulation(path, NX_RAW, NY_RAW, nz_raw,
                                     seed=2 * d + s, packed=("x_wind_ml",),
                                     fill=fill if first else None)
            else:
                _write_fake_nc(path, nx=NX_RAW, ny=NY_RAW, nz_raw=nz_raw,
                               poison_hour=5 if first else None,
                               seed=2 * d + s)


def twin(tmp_path, **kw):
    """Two data roots holding the same raw files: (JAX's, the port's)."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    seed_raw(jroot, **kw)
    shutil.copytree(raw_dir(jroot), raw_dir(proot))
    return jroot, proot


def written(root):
    """{path relative to root: bytes} of every file the downloader wrote:
    the cache and the raw folder's ledger."""
    out = {}
    for top in ("full_dataset_files", "downloaded_raw_bessaker_data"):
        for dirpath, _, names in os.walk(os.path.join(root, top)):
            for n in names:
                if n.endswith(".nc"):
                    continue
                path = os.path.join(dirpath, n)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def download_both(jroot, proot, start=DAY, end=DAY, nz=NZ):
    names_j = jdl.download_dataset(jroot, start, end, nz)
    names_p = pdl.download_dataset(proot, start, end, nz)
    assert names_p == names_j
    got, want = written(proot), written(jroot)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    return names_p, got


def plain_hour(path, t, nz):
    """Hour ``t`` of a raw file by hand: the packed variables unpacked
    (int16 → float64 × scale + offset, the fill as NaN), float64, (x, y, z)
    with z reversed, the crop x 4:-4, y 4:-3, z 1:1+nz; → (z, u, v, w, p)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False, maskandscale=False)
    try:
        out = {}
        for name in RAW_FIELDS:
            var = f.variables[name]
            a = var.data[t].astype(np.float64)
            if "scale_factor" in var._attributes:
                a = a * var.scale_factor + var.add_offset
                a[var.data[t] == var._FillValue] = np.nan
            out[name] = np.transpose(a, (1, 2, 0))[:, :, ::-1][
                4:-4, 4:-3, 1:1 + nz]
    finally:
        f.close()
    return tuple(out[n] for n in ("geopotential_height_ml", "x_wind_ml",
                                  "y_wind_ml", "upward_air_velocity_ml",
                                  "air_pressure_ml"))


def test_names_and_urls_match_jax():
    for name in ("BASE_URL", "DATA_CODE", "SIM_TIMES", "X_SLICE",
                 "Y_SLICE"):
        assert getattr(pdl, name) == getattr(jdl, name), name
    for day in (date(2018, 3, 7), date(2019, 12, 31), date(2020, 2, 29)):
        for stamp in pdl.SIM_TIMES:
            assert pdl.nc_url(day, stamp) == jdl.nc_url(day, stamp)
            assert pdl.raw_filename(day, stamp) == jdl.raw_filename(
                day, stamp)
            assert pdl._hour_names(day, stamp) == jdl._hour_names(
                day, stamp)
    assert pdl.nc_url(date(2018, 3, 7), "T00Z.nc") == (
        "https://thredds.met.no/thredds/fileServer/opwind/2018/03/07/"
        "simra_BESSAKER_20180307T00Z.nc")


@pytest.mark.parametrize("case", ["ok", "nan", "inf", "wind", "pressure",
                                  "negative_wind", "zag_nan"])
def test_sample_filter_matches_jax(case):
    """JAX's cases (tests/test_downloader_units.py) and three more."""
    arrays = [np.ones((4, 4, 2)) for _ in range(6)]
    index, value = {"ok": (2, 1.0), "nan": (2, np.nan), "inf": (4, np.inf),
                    "wind": (3, 101.0), "pressure": (5, 2.5e5),
                    "negative_wind": (2, -150.0),
                    "zag_nan": (1, np.nan)}[case]
    arrays[index][0, 0, 0] = value
    got = pdl.sample_is_invalid(*arrays)
    assert got == jdl.sample_is_invalid(*arrays)
    assert got == (case not in ("ok", "negative_wind"))


def test_scipy_reader_unpacks_like_jax(tmp_path):
    """A packed int16 variable with a fill: masked and unpacked through
    scale_factor / add_offset as JAX's shim does, and NaN after
    ``np.ma.filled``; the port's raw writer's packing reads back as
    int16 × scale + offset."""
    path = str(tmp_path / "raw.nc")
    write_raw_simulation(path, 9, 9, 3, nt=2, seed=4,
                         packed=("x_wind_ml", "y_wind_ml"),
                         fill=(1, "x_wind_ml"))
    readers = (pdl._ScipyNC(path), jdl._ScipyNC(path))
    try:
        for name in RAW_FIELDS:
            got, want = (r[name][:] for r in readers)
            assert np.array_equal(np.ma.getmaskarray(got),
                                  np.ma.getmaskarray(want)), name
            assert np.array_equal(np.ma.filled(got.astype(float), np.nan),
                                  np.ma.filled(want.astype(float), np.nan),
                                  equal_nan=True), name
        packed = readers[0]["x_wind_ml"][:]
        assert np.ma.count_masked(packed) == 1 and np.ma.is_masked(
            packed[1, 1, 4, 4])
        assert packed.dtype == np.float64
        filled = np.ma.filled(packed.astype(float), np.nan)
        assert np.isnan(filled).sum() == 1
    finally:
        for r in readers:
            r.close()
    plain = pdl._ScipyNC(path)
    try:
        raw = plain._f.variables["x_wind_ml"].data
        u = plain["x_wind_ml"][:]
        assert raw.dtype.kind == "i" and raw.itemsize == 2
        assert (raw == PACK_FILL).sum() == 1
        keep = raw != PACK_FILL
        assert np.array_equal(u.data[keep],
                              raw[keep] * PACK_SCALE + PACK_OFFSET)
        z = plain["geopotential_height_ml"][:]
        assert z.dtype.kind == "f" and z.itemsize == 4
        assert not np.ma.isMaskedArray(z)
    finally:
        plain.close()


def test_open_nc_takes_netcdf4_at_call_time(tmp_path, monkeypatch):
    """netCDF4 where it imports (looked up at each call), else scipy."""
    opened = []
    fake = types.ModuleType("netCDF4")
    fake.Dataset = lambda path, mode: opened.append((path, mode)) or "nc4"
    monkeypatch.setitem(sys.modules, "netCDF4", fake)
    assert pdl.open_nc("a.nc") == "nc4" and opened == [("a.nc", "r")]
    monkeypatch.setitem(sys.modules, "netCDF4", None)  # ImportError
    path = str(tmp_path / "raw.nc")
    write_raw_simulation(path, 9, 9, 3, nt=2)
    fid = pdl.open_nc(path)
    try:
        assert isinstance(fid, pdl._ScipyNC)
    finally:
        fid.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_download_matches_jax_bit_for_bit(tmp_path, no_network, writer):
    """Two days, the second's T12Z left out: 36 hours but the filled one;
    every file equal to JAX's byte for byte; each cached hour equal to a
    plain numpy re-extraction of its raw file; one fetch, for the absent
    file, which invalid_files.txt names."""
    days = (DAY, date(2018, 3, 8))
    absent = pdl.raw_filename(days[1], "T12Z.nc")
    jroot, proot = twin(tmp_path, days=days, skip={(days[1], "T12Z.nc")},
                        writer=writer)
    names, files = download_both(jroot, proot, days[0], days[1])
    assert names == [n for n in pfiles.filenames_from_dates(*days)[:36]
                     if n != "2018-03-07-05.pkl"]
    assert no_network.urls == [pdl.nc_url(days[1], "T12Z.nc")] * 2
    ledger = os.path.join("downloaded_raw_bessaker_data",
                          "invalid_files.txt")
    assert files[ledger].decode().splitlines() == [absent]
    folder = pfiles.dataset_folder(proot, f"bessaker_z{NZ}")
    with open(os.path.join(folder, "filtered_samples.txt")) as f:
        assert f.read().splitlines() == ["2018-03-07-05.pkl"]
    terrain, x, y = pfiles.read_static(os.path.join(proot,
                                                    "full_dataset_files"))
    assert terrain.shape == (16, 16) and x.shape == y.shape == (16,)
    for name in names:
        day = date.fromisoformat(name[:10])
        hour = int(name[11:13])
        stamp = pdl.SIM_TIMES[hour // 12]
        z, u, v, w, p = plain_hour(
            os.path.join(raw_dir(proot), pdl.raw_filename(day, stamp)),
            hour % 12, NZ)
        want = (z, z - terrain[:, :, None], u, v, w, p)
        for a, b in zip(pfiles.read_sample(folder, name), want):
            assert a.dtype == np.float64 and np.array_equal(a, b), name


@pytest.mark.parametrize("branch", ["missing_remote", "corrupt_file",
                                    "filtered_hour"])
def test_failure_branches_match_jax(tmp_path, no_network, branch):
    """Each of the three ways an hour or a file drops out, against JAX."""
    if branch == "missing_remote":
        jroot, proot = twin(tmp_path, skip={(DAY, "T00Z.nc")}, fill=None)
    else:
        jroot, proot = twin(tmp_path, fill=(3, "upward_air_velocity_ml"))
    if branch == "corrupt_file":
        for root in (jroot, proot):
            with open(os.path.join(raw_dir(root), pdl.raw_filename(
                    DAY, "T12Z.nc")), "wb") as f:
                f.write(b"CDF\x01 truncated")
    names, files = download_both(jroot, proot)
    ledger = files.get(os.path.join("downloaded_raw_bessaker_data",
                                    "invalid_files.txt"), b"").decode()
    filtered = files.get(os.path.join("full_dataset_files",
                                      f"bessaker_z{NZ}",
                                      "filtered_samples.txt"), b"").decode()
    if branch == "missing_remote":
        assert ledger.splitlines() == [pdl.raw_filename(DAY, "T00Z.nc")]
        assert len(no_network.urls) == 2 and not filtered
        assert names == pdl._hour_names(DAY, "T12Z.nc")
    elif branch == "corrupt_file":
        assert ledger.splitlines() == [pdl.raw_filename(DAY, "T12Z.nc")]
        assert not no_network.urls and filtered.splitlines() == [
            "2018-03-07-03.pkl"]
        assert len(names) == 11
    else:
        assert not ledger and filtered.splitlines() == ["2018-03-07-03.pkl"]
        assert len(names) == 23


def test_filter_is_per_z_config(tmp_path, no_network):
    """JAX's writer poisons raw level 2, inside the z3 crop and outside
    z1's: the hour is filtered at z3 and valid at z1, in both packages."""
    jroot, proot = twin(tmp_path, writer="jax")
    names3, _ = download_both(jroot, proot, nz=3)
    names1, _ = download_both(jroot, proot, nz=1)
    assert "2018-03-07-05.pkl" not in names3
    assert "2018-03-07-05.pkl" in names1


def test_fetch_through_urlretrieve(tmp_path, monkeypatch):
    """A raw file absent from disk is fetched by urlretrieve (looked up
    at call time) from nc_url into the raw folder, then read as if it had
    been there: the same files as JAX's, one fetch per package."""
    stash = str(tmp_path / "stash")
    seed_raw(stash)
    fetched = []

    def fetch(url, local):
        fetched.append((url, os.path.basename(local)))
        shutil.copy(os.path.join(raw_dir(stash), os.path.basename(local)),
                    local)

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    names, _ = download_both(jroot, proot)
    assert len(names) == 23
    want = [(pdl.nc_url(DAY, s), pdl.raw_filename(DAY, s))
            for s in pdl.SIM_TIMES]
    assert fetched == want * 2


def test_second_call_does_no_rework(tmp_path, no_network, monkeypatch):
    """A warm cache: the same names, no raw file opened, no fetch, no file
    rewritten (mtimes) — the port as JAX."""
    jroot, proot = twin(tmp_path, skip={(DAY, "T12Z.nc")})
    first, _ = download_both(jroot, proot)
    urls = list(no_network.urls)

    def boom(path):
        raise AssertionError("raw .nc re-parsed on a warm cache")

    mtimes = {}
    for dirpath, _, names in os.walk(proot):
        for n in names:
            path = os.path.join(dirpath, n)
            mtimes[path] = os.stat(path).st_mtime_ns
    monkeypatch.setattr(pdl, "open_nc", boom)
    monkeypatch.setattr(jdl, "open_nc", boom)
    second, _ = download_both(jroot, proot)
    assert second == first and no_network.urls == urls
    assert {p: os.stat(p).st_mtime_ns for p in mtimes} == mtimes
