"""PyTorch port: the real-data path against the JAX package on the CPU, with
no network (``urllib.request.urlretrieve`` replaced by a function that
raises): raw HARMONIE-layout files of the port's analytic writer (three
days at JAX's tiny raw grid, 24 × 23, 6 raw levels; x_wind_ml packed as
int16, one hour filled, one file left out) → ``preprocess(cfg,
synthetic=False)`` → downloader → hourly cache → norm stats →
chronological split → ``WindDataset`` → ``train`` → ``run_test``, at the
tiny configuration of ``tests/_torch_tiny.py`` (4 levels kept, 16×16).

- ``preprocess``: the split names and lengths, the norm stats, ``x``,
  ``y`` and every item ``get(i, rng)`` of the three splits equal to JAX's;
  on a warm cache no download; ``RuntimeError`` when nothing is cached
  and nothing can be downloaded, as JAX;
- a 4-step ``train`` from one JAX initial state against JAX's: the logged
  losses and the validation metrics within 1e-3 of their largest
  (``tests/test_torch_loop.py``), the final G within 1e-3 of each
  tensor's largest entry, D entry by entry within 2·lr a D step (Adam's
  ±lr steps on its small first gradients, ``ROADMAP.md`` §3);
- the command line on the CPU: ``--download``, then ``--train`` and
  ``--test`` without ``--synthetic``.
"""

import dataclasses
import os
import shutil
import urllib.request
from datetime import date, timedelta

import jax
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE
from gan_sr_wind_field_tpu.data import preprocess as jax_preprocess
from gan_sr_wind_field_tpu.train.continuation import save_continuation
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.train.loop import train as jax_train
from gan_sr_wind_field_tpu.utils.logging import (
    setup_loggers as jax_setup_loggers,
)
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.data import downloader as pdl
from gan_sr_wind_field_tpu_torch.data import files as pfiles
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.data.synthetic import write_raw_simulation
from gan_sr_wind_field_tpu_torch.eval import test_loop as tl
from gan_sr_wind_field_tpu_torch.train.loop import train
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers
from test_torch_loop import _events, _status_losses, loop_cfg

NX_RAW, NY_RAW, NZ_RAW = 24, 23, 6
START = date(2018, 3, 7)
DAYS = 3
ABSENT = (START + timedelta(days=1), "T12Z.nc")
FILLED = "2018-03-07-05.pkl"
HOURS = DAYS * 24 - 12 - 1  # a file left out, an hour filtered


@pytest.fixture()
def no_network(monkeypatch):
    urls = []

    def fetch(url, local):
        urls.append(url)
        raise OSError(f"no network: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    return urls


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    """The raw folder, written once: three days, T00Z and T12Z, but the
    second day's T12Z."""
    folder = tmp_path_factory.mktemp("raw") / "downloaded_raw_bessaker_data"
    folder.mkdir()
    for d in range(DAYS):
        day = START + timedelta(days=d)
        for s, stamp in enumerate(pdl.SIM_TIMES):
            if (day, stamp) == ABSENT:
                continue
            write_raw_simulation(
                str(folder / pdl.raw_filename(day, stamp)), NX_RAW, NY_RAW,
                NZ_RAW, seed=2 * d + s, packed=("x_wind_ml",),
                fill=(5, "upward_air_velocity_ml") if d + s == 0 else None)
    return folder


def real_cfg(port, root, raw_files, niter=4):
    """``loop_cfg`` on the raw files' dates, its data root under ``root``
    holding a copy of them."""
    cfg = loop_cfg(port, root, niter=niter)
    g = cfg.gan_config
    end = START + timedelta(days=DAYS - 1)
    g.start_date = [START.year, START.month, START.day]
    g.end_date = [end.year, end.month, end.day]
    shutil.copytree(raw_files, os.path.join(cfg.env.data_root,
                                            "downloaded_raw_bessaker_data"))
    return cfg


def _items(ds, n=None):
    return [ds.get(i, np.random.default_rng(i))
            for i in range(len(ds) if n is None else n)]


def test_preprocess_matches_jax(tmp_path, raw_files, no_network):
    """Cold cache: the download over the raw files, then stats, split and
    datasets, each equal to JAX's; one fetch each, for the absent file."""
    out = {}
    for port in (False, True):
        cfg = real_cfg(port, tmp_path / ("port" if port else "jax"),
                       raw_files)
        out[port] = (preprocess if port else jax_preprocess)(
            cfg, synthetic=False)
    assert no_network == [pdl.nc_url(*ABSENT)] * 2
    (*dj, xj, yj), (*dp, xp, yp) = out[False], out[True]
    assert np.array_equal(xp, xj) and np.array_equal(yp, yj)
    assert xp.dtype == xj.dtype == np.float32 and xp.shape == (16,)
    gone = {FILLED, *pdl._hour_names(*ABSENT)}
    names = [n for n in pfiles.filenames_from_dates(
        START, START + timedelta(days=DAYS - 1)) if n not in gone]
    assert len(names) == HOURS
    n_train, n_test = int(HOURS * 0.8), int(HOURS * 0.1)
    assert [len(d) for d in dp] == [n_train, n_test,
                                    HOURS - n_train - n_test]
    assert sum((d.filenames for d in dp), []) == names
    for a, b in zip(dp, dj):
        assert a.filenames == b.filenames
        assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)
        for ga, gb in zip(_items(a), _items(b)):
            assert len(ga) == len(gb)
            for u, v in zip(ga, gb):
                if isinstance(v, np.ndarray):
                    assert u.dtype == v.dtype and np.array_equal(u, v)
                else:
                    assert u == v
    lr, hr, z = dp[0].get(0, np.random.default_rng(0))
    assert hr.shape == (16, 16, 4, 3) and lr.shape[:3] == (4, 4, 4)
    assert np.isfinite(hr).all() and np.isfinite(lr).all()


def test_warm_cache_is_not_downloaded_again(tmp_path, raw_files, no_network,
                                            monkeypatch):
    """A second ``preprocess`` finds the cache and calls no download."""
    cfg = real_cfg(True, tmp_path, raw_files)
    first = preprocess(cfg, synthetic=False)

    def boom(*a, **kw):
        raise AssertionError("downloaded over a warm cache")

    monkeypatch.setattr(pdl, "download_dataset", boom)
    second = preprocess(cfg, synthetic=False)
    for a, b in zip(first[:3], second[:3]):
        assert a.filenames == b.filenames and a.stats == b.stats
    assert len(no_network) == 1


def test_nothing_cached_nor_downloaded_raises(tmp_path, no_network):
    """No raw file and no network: RuntimeError in both packages, after
    one fetch per file of the range."""
    for port in (False, True):
        cfg = loop_cfg(port, tmp_path / str(port))
        cfg.gan_config.start_date = cfg.gan_config.end_date = [2018, 3, 7]
        with pytest.raises(RuntimeError, match="no valid samples"):
            (preprocess if port else jax_preprocess)(cfg, synthetic=False)
    assert len(no_network) == 4


def test_four_steps_match_jax_train(tmp_path, raw_files, no_network):
    """Host data path, no augmentation, 4 steps (G, D, D, G) with a
    validation at 4, from a float32 pack of a JAX initial state, on the
    real-format datasets of each package."""
    jgan = JaxGAN(loop_cfg(False, tmp_path), COORDS, COORDS)
    js = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    pack = str(tmp_path / "init.npz")
    save_continuation(pack, *(jax.tree.map(np.asarray, t) for t in
                              (js.params_G, js.params_D, js.batch_stats_D)),
                      it=0, store_dtype="float32")
    logs, states = {}, {}
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = real_cfg(port, root, raw_files)
        cfg.load_model_from_save = True
        cfg.env.generator_load_path = pack
        cfg.training.log_period = 1
        cfg.training.val_period = 4
        (setup_loggers if port else jax_setup_loggers)(
            str(root / "log"), also_log_to_terminal=False)
        ds_train, _, ds_val, x, y = (preprocess if port else jax_preprocess)(
            cfg, synthetic=False)
        states[port] = (train(cfg, ds_train, ds_val, x, y, device="cpu")
                        if port else jax_train(cfg, ds_train, ds_val, x, y))
        assert int(states[port].it) == 4
        logs[port] = (_status_losses(root / "log" / "status.log"),
                      _events(root / "run" / "tb" / "events.jsonl"))
    (steps_j, val_j), ev_j = logs[False]
    (steps_p, val_p), ev_p = logs[True]
    assert sorted(steps_p) == sorted(steps_j) == [1, 2, 3, 4]
    for key in ev_j[1]:
        want = np.array([ev_j[s][key] for s in sorted(ev_j)])
        got = np.array([ev_p[s][key] for s in sorted(ev_j)])
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(),
                                                      1e-12), key
    d_j = np.array([steps_j[s][1] for s in sorted(steps_j)])
    d_p = np.array([steps_p[s][1] for s in sorted(steps_j)])
    assert np.abs(d_p - d_j).max() <= 1e-3 * np.abs(d_j).max()
    assert len(val_p) == len(val_j) == 1
    for g, w in zip(val_p[0][1:], val_j[0][1:]):
        assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w))

    got, js = states[True], states[False]
    n_d = int((d_j > 0).sum())
    assert n_d == 2
    assert (got.params_G_ema is None) == (js.params_G_ema is None)
    trees = [(got.params_G, params_from_jax(
        jax.tree.map(np.asarray, js.params_G)))]
    if js.params_G_ema is not None:
        trees.append((got.params_G_ema, params_from_jax(
            jax.tree.map(np.asarray, js.params_G_ema))))
    want_d = d_params_from_jax(jax.tree.map(np.asarray, js.params_D),
                               jax.tree.map(np.asarray, js.batch_stats_D))
    for tree, want in trees:
        assert set(tree) == set(want)
        for k, w in want.items():
            bound = 1e-3 * max(1e-8, w.abs().max().item())
            assert (tree[k].detach() - w).abs().max().item() <= bound, k
    # D: Adam turns the rounding of its small first gradients into steps
    # of ±lr (ROADMAP.md §3; every D tensor of this leg has such entries),
    # so D is held entry by entry to 2·lr a D step; its statistics follow
    # those weights, and the losses and validation metrics above hold both
    assert set(got.params_D) | set(got.batch_stats_D) == set(want_d)
    for k, w in want_d.items():
        if k in got.params_D:
            d = (got.params_D[k].detach() - w).abs().max().item()
            assert d <= 2 * 1e-3 * n_d, k
        else:
            assert torch.isfinite(got.batch_stats_D[k]).all(), k


def test_cli_download_then_train_and_test(tmp_path, raw_files, no_network,
                                          monkeypatch):
    """``--download`` alone fills the cache (no device needed) and returns
    its hours; ``--train`` and ``--test`` without ``--synthetic`` read it,
    and no command tries the network past the one absent file."""
    cfg = real_cfg(True, tmp_path, raw_files)
    cfg.name = "realdata"
    cfg.also_log_to_terminal = False
    cfg.training.log_period = cfg.training.save_model_period = 4
    ini = str(tmp_path / "real.ini")
    cfg.save(ini)
    names = run.main(["--cfg", ini, "--download"])
    assert len(names) == HOURS and FILLED not in names
    assert no_network == [pdl.nc_url(*ABSENT)]
    with open(os.path.join(cfg.env.data_root, "downloaded_raw_bessaker_data",
                           "invalid_files.txt")) as f:
        assert f.read().splitlines() == [pdl.raw_filename(*ABSENT)]

    state = run.main(["--cfg", ini, "--train", "--device", "cpu",
                      "--max_steps", "4"])
    assert state.it == 4
    runs = sorted(os.listdir(tmp_path / "runs"))
    folder = tmp_path / "runs" / runs[-1]
    assert "ckpt_4" in os.listdir(folder)
    status = (tmp_path / "log" / "status.log").read_text()
    assert "it 4 G_total" in status and "download finished" in status

    cfg.env.generator_load_path = str(folder / "ckpt_4")
    cfg.save(ini)
    monkeypatch.chdir(tmp_path)
    avgs = run.main(["--cfg", ini, "--test", "--device", "cpu"])
    assert np.isfinite(avgs["PSNR"])
    with open(tmp_path / "test_output" / "realdata____metrics.csv") as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == int(HOURS * 0.1)
    assert all(np.isfinite(float(r.split(",")[1])) for r in rows)
    with open(tmp_path / "test_output" / "averages.csv") as f:
        assert f.read().splitlines()[0] == tl.AVG_HEADER.strip()
    assert len(no_network) == 1
