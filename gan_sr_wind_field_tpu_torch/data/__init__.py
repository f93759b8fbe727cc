"""Data preparation and input pipeline of the port.

The port's own copy of ``gan_sr_wind_field_tpu/data/``: the hourly-sample
cache (``files.py``), the synthetic analytic source (``synthetic.py``),
normalization stats and the chronological split, ``WindDataset`` (patch
slicing and equivariant augmentation), the float32 memmap cache
(``npcache.py``), the host→device prefetch (``pipeline.py``) and the
device-resident batcher (``device_data.py``). The downloader
(``data/downloader.py``) is not ported: there is no network, and training
data comes from ``--synthetic``.
"""

from __future__ import annotations

import os

import numpy as np

from gan_sr_wind_field_tpu_torch.data import files as dfiles
from gan_sr_wind_field_tpu_torch.data.dataset import (
    WindDataset,
    aggregate_norm_stats,
    chronological_split,
)
from gan_sr_wind_field_tpu_torch.data.synthetic import (
    generate_synthetic_cache,
)
from gan_sr_wind_field_tpu_torch.data.transform import (
    NormStats,
    reformat_sample,
)

__all__ = [
    "WindDataset",
    "NormStats",
    "aggregate_norm_stats",
    "chronological_split",
    "filenames_from_dates",
    "generate_synthetic_cache",
    "preprocess",
    "reformat_sample",
]

filenames_from_dates = dfiles.filenames_from_dates


def preprocess(cfg, synthetic: bool = False, synthetic_hours: int = 48,
               synthetic_size: int = 64):
    """Build the three split datasets and the coordinate axes from config:
    → (dataset_train, dataset_test, dataset_validation, x, y), as
    ``gan_sr_wind_field_tpu.data.preprocess`` does. Only the synthetic
    source is ported; without ``synthetic`` this raises."""
    if not synthetic:
        raise NotImplementedError(
            "only --synthetic data is ported: data/downloader.py (the "
            "HARMONIE-SIMRA download) is not ported (see ROADMAP.md)")
    g = cfg.gan_config
    root = cfg.env.data_root
    ratio = cfg.training.train_eval_test_ratio

    names, sub = generate_synthetic_cache(
        root,
        num_hours=synthetic_hours,
        nx=synthetic_size,
        ny=synthetic_size,
        nz=g.number_of_z_layers,
    )
    folder = dfiles.dataset_folder(root, sub)
    terrain, x, y = dfiles.read_static(
        folder, os.path.join(root, "full_dataset_files")
    )

    stats = aggregate_norm_stats(folder, names, ratio)
    if not os.path.isfile(dfiles.norm_factors_path(folder)):
        dfiles.write_norm_factors(folder, stats)

    train_names, test_names, val_names = chronological_split(names, ratio)
    interp_dir = dfiles.interp_cache_folder(root, sub)

    common = dict(
        stats=stats,
        x=x,
        y=y,
        terrain=terrain,
        coarseness_factor=cfg.scale,
        include_pressure=g.include_pressure,
        include_z_channel=g.include_z_channel,
        include_above_ground_channel=g.include_above_ground_channel,
        interpolate_z=g.interpolate_z,
        slice_size=g.slice_size,
        interp_cache_dir=interp_dir,
    )

    dt = cfg.dataset_train
    ds_train = WindDataset(
        folder, train_names,
        enable_slicing=g.enable_slicing,
        data_aug_rot=dt.data_aug_rot if dt else False,
        data_aug_flip=dt.data_aug_flip if dt else False,
        **common,
    )
    # test: full volumes, no augmentation (reference process_data.py:575-599)
    ds_test = WindDataset(
        folder, test_names, enable_slicing=False, is_test=True, **common
    )
    # the deterministic val track disables augmentation (offsets are fixed
    # by the sweep's numpy seed in train/loop.run_validation)
    val_det = bool(cfg.dataset_val and cfg.dataset_val.deterministic)
    ds_val = WindDataset(
        folder, val_names,
        enable_slicing=g.enable_slicing,
        data_aug_rot=bool(cfg.dataset_val and cfg.dataset_val.data_aug_rot
                          and not val_det),
        data_aug_flip=bool(cfg.dataset_val and cfg.dataset_val.data_aug_flip
                           and not val_det),
        **common,
    )

    if g.enable_slicing:  # regular spacing — values irrelevant beyond dx
        x = x[: g.slice_size]
        y = y[: g.slice_size]
    return (
        ds_train,
        ds_test,
        ds_val,
        np.asarray(x, np.float32),
        np.asarray(y, np.float32),
    )
