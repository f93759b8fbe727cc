"""PyTorch port: the physics-weight search (``search/``) against the JAX
package, on the CPU at the tiny configuration of ``tests/_torch_tiny.py``.

- ``ASHAScheduler``: the same decisions as JAX's on the same report
  sequences, alone and as two shards sharing rung files, which hold the
  same lines;
- ``SEARCH_SPACE``, ``INITIAL_POINTS`` and ``sample_point`` equal JAX's;
- ``run_trial`` equals a bare loop of weighted ``train_step`` and
  ``val_step`` calls from the trial's seed, bit for bit, with host batches
  and with ``device_resident_data``;
- a micro sweep through ``run.main(["--param_search", ...])`` writes
  JAX's record format: ``param_search.jsonl`` and
  ``param_search_best.json`` with JAX's keys, points and types.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.search import asha as jasha
from gan_sr_wind_field_tpu.search import driver as jdriver
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher
from gan_sr_wind_field_tpu_torch.search import asha, driver
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.loop import val_seed
from test_torch_loop import HOURS, SIZE, _data, assert_states_equal, loop_cfg


def _reports(seed, n_trials, rungs):
    """A report sequence: trials in turns, each reporting at every rung
    until the scheduler stops it; PSNRs seeded, some tied."""
    rng = np.random.default_rng(seed)
    return [(t, r, float(np.round(rng.normal(20, 2), 1)))
            for r in rungs for t in range(n_trials)]


@pytest.mark.parametrize("grace,eta,max_t", [(2, 2, 16), (3, 3, 100),
                                             (1, 4, 64), (40, 3, 400)])
def test_asha_decisions_equal_jax(grace, eta, max_t):
    ours = asha.ASHAScheduler(max_t=max_t, grace_period=grace,
                              reduction_factor=eta)
    theirs = jasha.ASHAScheduler(max_t=max_t, grace_period=grace,
                                 reduction_factor=eta)
    assert ours.rung_iterations() == theirs.rung_iterations()
    rungs = ours.rung_iterations() + [max_t]
    live = set(range(9))
    for trial, it, metric in _reports(grace * eta, 9, rungs):
        if trial not in live:
            continue
        a, b = ours.report(it, metric), theirs.report(it, metric)
        assert a == b, (trial, it, metric)
        if not a:
            live.discard(trial)
    assert ours.rungs == theirs.rungs


def test_asha_shards_share_rung_files_as_jax_does(tmp_path):
    def pair(root):
        return [cls(max_t=27, grace_period=3, reduction_factor=3,
                    share_dir=str(root), shard_index=i)
                for cls, i in ((asha.ASHAScheduler, 0),
                               (asha.ASHAScheduler, 1))]

    ours = pair(tmp_path / "port")
    theirs = [jasha.ASHAScheduler(max_t=27, grace_period=3,
                                  reduction_factor=3,
                                  share_dir=str(tmp_path / "jax"),
                                  shard_index=i) for i in (0, 1)]
    for trial, it, metric in _reports(3, 8, [3, 9]):
        shard = trial % 2
        assert ours[shard].report(it, metric) == \
            theirs[shard].report(it, metric), (trial, it)
    for i in (0, 1):
        name = f"asha_rungs.shard{i}.jsonl"
        with open(tmp_path / "port" / name) as f, \
                open(tmp_path / "jax" / name) as g:
            assert f.read() == g.read()
        assert ours[i].rungs == theirs[i].rungs


def test_search_space_and_points_equal_jax():
    assert driver.SEARCH_SPACE == jdriver.SEARCH_SPACE
    assert driver.INITIAL_POINTS == jdriver.INITIAL_POINTS
    for seed in (0, 2001):
        for i in range(25):
            assert driver.sample_point(i, seed) == jdriver.sample_point(
                i, seed)
            want = (jdriver.INITIAL_POINTS[i] if i < 10
                    else jdriver.sample_point(i - 10, seed=seed))
            assert driver.trial_point(i, seed) == want
    w = driver.point_to_weights(driver.INITIAL_POINTS[3])
    jw = jdriver.point_to_weights(driver.INITIAL_POINTS[3])
    assert sorted(w) == sorted(jw)
    for k in w:
        assert w[k].dtype == torch.float32 and w[k].dim() == 0
        assert w[k].item() == float(jw[k])


def _search_cfg(tmp_path, resident, **training):
    cfg = loop_cfg(True, tmp_path, niter=5, val_period=2, **training)
    cfg.device_resident_data = resident
    cfg.dataset_val.deterministic = True
    cfg.dataset_train.data_aug_rot = cfg.dataset_train.data_aug_flip = True
    return cfg


def test_run_trial_needs_the_sweeps_batcher(tmp_path):
    """Under device_resident_data the sweep's DeviceBatcher is the one
    stream of uploaded volumes; run_trial makes none of its own."""
    cfg = _search_cfg(tmp_path, True)
    ds_train, _, ds_val, x, y = _data(cfg)
    gan = WindFieldGAN(cfg, x, y, device="cpu")
    sched = asha.ASHAScheduler(max_t=5, grace_period=2, reduction_factor=2)
    with pytest.raises(ValueError, match="DeviceBatcher"):
        driver.run_trial(gan, cfg, ds_train, ds_val,
                         driver.trial_point(0, cfg.env.fixed_seed), sched, 0,
                         2, logging.getLogger("status"))


@pytest.mark.parametrize("resident", [False, True])
def test_run_trial_is_a_bare_weighted_loop(tmp_path, resident,
                                           monkeypatch):
    """Trial 1 (its point INITIAL_POINTS[1]) under ASHA rungs at 2 and 4:
    its record and final state against weighted train_step / val_step
    calls from its seed, with the same batches and validation draws."""
    cfg = _search_cfg(tmp_path, resident)
    ds_train, _, ds_val, x, y = _data(cfg)
    gan = WindFieldGAN(cfg, x, y, device="cpu")
    last = {}
    real = WindFieldGAN.train_step

    def spy(self, state, *a, **kw):
        last["state"] = state
        return real(self, state, *a, **kw)

    monkeypatch.setattr(WindFieldGAN, "train_step", spy)
    sched = asha.ASHAScheduler(max_t=5, grace_period=2, reduction_factor=2)
    point = driver.trial_point(1, cfg.env.fixed_seed)
    rec = driver.run_trial(gan, cfg, ds_train, ds_val, point, sched, 1, 2,
                           logging.getLogger("status"),
                           DeviceBatcher(ds_train, 2, "cpu") if resident
                           else None)
    monkeypatch.setattr(WindFieldGAN, "train_step", real)
    got = last["state"]
    assert rec["it"] == got.it == 5 and not rec["stopped_early"]

    seed = cfg.env.fixed_seed + 1
    weights = driver.point_to_weights(point)
    rng_np = np.random.default_rng(seed)
    lr0, hr0, _ = ds_train.get(0, rng_np)
    state = gan.init_state(seed, (2,) + lr0.shape, (2,) + hr0.shape)
    batches = (DeviceBatcher(ds_train, 2, "cpu", seed=seed) if resident
               else ds_train.batches(2, rng_np, shuffle=True, epochs=5))
    psnrs = []
    for it in range(1, 6):
        state, _ = gan.train_step(state, *next(iter(batches)), augment=True,
                                  weights=weights)
        if it in (2, 4):
            vals = []
            for bi, vb in enumerate(ds_val.batches(
                    2, np.random.default_rng(cfg.env.fixed_seed),
                    shuffle=False, drop_remainder=False)):
                gen = torch.Generator().manual_seed(val_seed(seed, it, bi))
                m, _ = gan.val_step(state, *vb, generator=gen,
                                    weights=weights)
                vals.append(float(m["val_PSNR"]))
            psnrs.append(float(np.mean(vals)))
    assert_states_equal(got, state)
    assert rec["PSNR"] == psnrs[-1] and rec["best_PSNR"] == max(psnrs)


def test_cli_micro_sweep_writes_jax_records(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _search_cfg(tmp_path, resident=True)
    cfg.also_log_to_terminal = False
    ini = str(tmp_path / "search.ini")
    cfg.save(ini)
    recs = run.main(["--cfg", ini, "--param_search", "--synthetic",
                     "--synthetic_hours", str(HOURS), "--synthetic_size",
                     str(SIZE), "--device", "cpu", "--num_samples", "3",
                     "--asha_grace", "2", "--asha_eta", "2"])
    (name,) = os.listdir(tmp_path / "runs")
    folder = tmp_path / "runs" / name
    with open(folder / "param_search.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    with open(folder / "param_search_best.json") as f:
        best = json.load(f)
    assert lines == json.loads(json.dumps(recs))
    assert [r["trial"] for r in lines] == [0, 1, 2]
    for i, r in enumerate(lines):
        # JAX's record: its keys in its order, its types
        assert list(r) == ["trial", "point", "it", "PSNR", "best_PSNR",
                           "stopped_early"]
        assert r["point"] == jdriver.INITIAL_POINTS[i]
        assert isinstance(r["stopped_early"], bool)
        assert np.isfinite(r["PSNR"]) and r["it"] in (2, 4, 5)
        assert r["stopped_early"] == (r["it"] < 5)
    assert best == max(lines, key=lambda r: r["best_PSNR"])
