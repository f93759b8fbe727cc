"""Model evaluation ("test") and inference ("use") over the held-out split.

Counterpart of ``gan_sr_wind_field_tpu/eval/test_loop.py``, with the same
CSV schema and field dumps:

- per run ``{output_root}/{name}____metrics.csv``: field, PSNR,
  PSNR_trilinear, relative_error, pix, trilinear_pix,
  relative_error_trilinear, average wind speed, old_pix, old_pix_trilinear
  (with the reference's irregular ``", "`` separators);
- one appended row of ``{output_root}/averages.csv`` per run;
- ``{run folder}/fields/test_fields_{name}.pkl`` dumps of HR/SR/TL/LR/Z,
  channels first (and HR_orig/Z_orig/SR_orig under ``interpolate_z``);
- under ``interpolate_z``, the metrics again on the raw terrain-following
  grid (``____metrics_reverse_interpolate.csv``).

The generator and the trilinear baseline run on the state's device; the
metrics are computed on the host in float64. ``pix`` is the mean
wind-vector error length in m/s, ``relative_error`` the mean error length
over the mean HR length, ``old_pix`` the plain L1 times ``uvw_max``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import pickle
from typing import Optional

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.zinterp import (
    reverse_interpolate_z_columns,
)
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

METRIC_HEADER = (
    "field, PSNR, PSNR_trilinear, relative_error, pix, trilinear_pix, "
    "relative_error_trilinear, average wind speed, old_pix, old_pix_trilinear\n"
)
AVG_HEADER = (
    "Name, Average PSNR, Average PSNR trilinear, Average pix, "
    "Average pix trilinear, Average old pix, Average old pix trilinear\n"
)


def _psnr(hr: np.ndarray, sr: np.ndarray) -> float:
    """``ops/metrics.py:psnr`` of one channels-last field, in float64."""
    mse = np.sum((hr - sr) ** 2) / np.prod(hr.shape[:3])
    return float(10.0 * np.log10(4.0 / (mse + 1e-8)))


def field_metrics(hr, sr, tl, uvw_max):
    """All scalar metrics for one field; channel-last (X,Y,Z,3) arrays."""
    hr = np.asarray(hr, np.float64)
    sr = np.asarray(sr, np.float64)
    tl = np.asarray(tl, np.float64)
    err_len = np.sqrt(np.sum((hr - sr) ** 2, axis=-1))
    tl_err_len = np.sqrt(np.sum((hr - tl) ** 2, axis=-1))
    hr_len = np.sqrt(np.sum(hr**2, axis=-1))
    mean_err = float(np.mean(err_len))
    mean_tl_err = float(np.mean(tl_err_len))
    mean_hr = float(np.mean(hr_len))
    return {
        "PSNR": _psnr(hr, sr),
        "PSNR_trilinear": _psnr(hr, tl),
        "relative_error": mean_err / mean_hr,
        "pix": mean_err * uvw_max,
        "trilinear_pix": mean_tl_err * uvw_max,
        "relative_error_trilinear": mean_tl_err / mean_hr,
        "average_wind_speed": mean_hr * uvw_max,
        "old_pix": float(np.mean(np.abs(hr - sr))) * uvw_max,
        "old_pix_trilinear": float(np.mean(np.abs(hr - tl))) * uvw_max,
    }


def _write_metric_row(f, name, m):
    f.write(
        f"{name},{m['PSNR']},{m['PSNR_trilinear']},{m['relative_error']},"
        f"{m['pix']},{m['trilinear_pix']}, {m['relative_error_trilinear']}, "
        f"{m['average_wind_speed']}, {m['old_pix']}, {m['old_pix_trilinear']}\n"
    )


def run_test(cfg, dataset_test, x, y, state=None,
             output_root: str = "./test_output",
             log_period: Optional[int] = None,
             ema: bool = False, device=None):
    """Evaluate the generator over the test split; write the CSVs and the
    field dumps. → the dict of run-average metrics.

    Without ``state`` the weights come from ``env.generator_load_path``,
    else from the newest checkpoint of ``env.this_runs_folder``. With
    ``ema=True`` the EMA slot is evaluated instead of the raw generator,
    and every output carries an ``_ema`` name suffix, so raw and EMA rows
    coexist in ``averages.csv``."""
    status = logging.getLogger("status")
    gan = WindFieldGAN(cfg, x, y, device=resolve_device(device))

    if state is None:
        run_folder = cfg.env.this_runs_folder or "."
        path = (cfg.env.generator_load_path
                or ckpt.latest_checkpoint(run_folder))
        if path is None:
            raise FileNotFoundError(
                "no checkpoint found; set env.generator_load_path"
            )
        state = ckpt.load_generator_state(cfg, gan, path)
        status.info(f"loaded generator from {path}")

    if ema:
        if state.params_G_ema is None:
            raise ValueError(
                "ema=True but the checkpoint carries no EMA slot "
                "(train with g_ema_decay > 0)"
            )
        state = dataclasses.replace(state, params_G=state.params_G_ema)
        status.info("evaluating the EMA generator slot")

    run_name = f"{cfg.name}_ema" if ema else cfg.name

    os.makedirs(output_root, exist_ok=True)
    run_folder = cfg.env.this_runs_folder or output_root
    fields_dir = os.path.join(run_folder, "fields")
    os.makedirs(fields_dir, exist_ok=True)

    avg_path = os.path.join(output_root, "averages.csv")
    if not os.path.exists(avg_path):
        with open(avg_path, "w") as f:
            f.write(AVG_HEADER)

    metrics_path = os.path.join(output_root, f"{run_name}____metrics.csv")
    sums = {}
    sums_ri = {}
    n = 0
    log_period = log_period or max(1, cfg.training.log_period)
    uvw_max = dataset_test.stats.uvw_max

    ri_path = os.path.join(
        output_root, f"{run_name}____metrics_reverse_interpolate.csv")
    with open(metrics_path, "w") as mf, (
            open(ri_path, "w") if cfg.gan_config.interpolate_z
            else contextlib.nullcontext()) as rif:
        mf.write(METRIC_HEADER)
        if rif is not None:
            rif.write(METRIC_HEADER)
        rng_np = np.random.default_rng(0)
        for idx in range(len(dataset_test)):
            lr, hr, z, name, hr_raw, z_raw = dataset_test.get(idx, rng_np)
            sr = gan.generate(state, lr[None], z[None])[0].cpu().numpy()
            lr_d = torch.from_numpy(np.ascontiguousarray(lr[None, ..., :3]))
            tl = upsample_trilinear_xy(lr_d.to(gan.device), cfg.scale)
            tl = tl[0].cpu().numpy()
            m = field_metrics(hr[..., :3], sr, tl, uvw_max)
            _write_metric_row(mf, name, m)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1

            sr_orig = None
            if rif is not None and hr_raw is not None:
                # reverse z-interp: SR and TL back onto the raw per-column
                # grid (reference test.py:160-213)
                def raw_grid(a):
                    return np.stack([reverse_interpolate_z_columns(
                        a[..., c], z_raw[..., 0], z[..., 0])
                        for c in range(3)], axis=-1)

                sr_orig = raw_grid(sr)
                m_ri = field_metrics(hr_raw[..., :3], sr_orig, raw_grid(tl),
                                     uvw_max)
                _write_metric_row(rif, name, m_ri)
                for k, v in m_ri.items():
                    sums_ri[k] = sums_ri.get(k, 0.0) + v

            if idx % log_period == 0:
                fields = {
                    "HR": np.moveaxis(hr[..., :3], -1, 0),
                    "SR": np.moveaxis(sr, -1, 0),
                    "TL": np.moveaxis(tl, -1, 0),
                    "LR": np.moveaxis(lr, -1, 0),
                    "Z": z[..., 0],
                }
                if hr_raw is not None:
                    fields["HR_orig"] = np.moveaxis(hr_raw[..., :3], -1, 0)
                    fields["Z_orig"] = z_raw[..., 0]
                    if sr_orig is not None:
                        fields["SR_orig"] = np.moveaxis(sr_orig, -1, 0)
                with open(os.path.join(
                        fields_dir, f"test_fields_{name}.pkl"), "wb") as ff:
                    pickle.dump(fields, ff)

    avgs = {k: v / max(n, 1) for k, v in sums.items()}
    with open(avg_path, "a") as f:
        f.write(
            f"{run_name}, {avgs['PSNR']}, {avgs['PSNR_trilinear']}, "
            f"{avgs['pix']}, {avgs['trilinear_pix']}, {avgs['old_pix']}, "
            f"{avgs['old_pix_trilinear']}\n"
        )
    status.info(f"test averages: {avgs}")
    if sums_ri:
        avgs["reverse_interpolate"] = {
            k: v / max(n, 1) for k, v in sums_ri.items()
        }
    return avgs


def run_use(cfg, dataset_test, x, y, state=None, device=None):
    """SR-only inference dump of every test field to
    ``{run folder}/fields/test_fields_{name}.pkl`` (LR and SR, channels
    first; the reference ``--use`` path, test.py:106-121)."""
    if state is None:
        raise ValueError("run_use requires a restored state")
    gan = WindFieldGAN(cfg, x, y, device=resolve_device(device))
    run_folder = cfg.env.this_runs_folder or "."
    fields_dir = os.path.join(run_folder, "fields")
    os.makedirs(fields_dir, exist_ok=True)
    rng_np = np.random.default_rng(0)
    for idx in range(len(dataset_test)):
        lr, _hr, z, name, _, _ = dataset_test.get(idx, rng_np)
        sr = gan.generate(state, lr[None], z[None])[0].cpu().numpy()
        with open(
            os.path.join(fields_dir, f"test_fields_{name}.pkl"), "wb"
        ) as f:
            pickle.dump(
                {"LR": np.moveaxis(lr, -1, 0), "SR": np.moveaxis(sr, -1, 0)}, f
            )
