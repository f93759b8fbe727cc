"""Dataset over the hourly-sample cache + chronological split + norm stats
(the port's own copy of ``gan_sr_wind_field_tpu/data/dataset.py``: the
same batches for the same numpy seed).

Counterpart of the reference ``CustomizedDataset`` (process_data.py:26-270)
and ``download_all_files_and_prepare``'s stat aggregation
(process_data.py:327-366), with explicit RNG plumbing: every stochastic
choice (patch offset, augmentation) draws from a caller-provided
``np.random.Generator`` — reproducible and worker-safe by construction
(the reference relies on per-worker global numpy state).

Per-item path: load (pickle or memmap) → optional z-regrid (cached) →
optional random patch slice with Beta(0.25, 0.25) corner-biased offsets
(process_data.py:159-176) → reformat/normalize → optional equivariant
augmentation. Test mode returns (LR, HR, Z, name, HR_raw, Z_raw) like
process_data.py:264-268.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gan_sr_wind_field_tpu_torch.data import files as dfiles
from gan_sr_wind_field_tpu_torch.data.augment import augment_sample_np
from gan_sr_wind_field_tpu_torch.data.npcache import MemmapSource
from gan_sr_wind_field_tpu_torch.data.transform import (
    NormStats,
    reformat_sample,
)
from gan_sr_wind_field_tpu_torch.data.zinterp import interpolate_z_columns


def chronological_split(
    names: Sequence[str], train_ratio: float
) -> Tuple[List[str], List[str], List[str]]:
    """Train = first ``ratio``, test = next half of the remainder, val =
    rest — including the reference's float-truncation semantics
    (process_data.py:548-550): ``int(n·(1-ratio)/2)`` can round down."""
    n_train = int(len(names) * train_ratio)
    n_test = int(len(names) * (1 - train_ratio) / 2)
    names = list(names)
    return (
        names[:n_train],
        names[n_train : n_train + n_test],
        names[n_train + n_test :],
    )


def aggregate_norm_stats(
    folder: str, names: Sequence[str], train_ratio: float
) -> NormStats:
    """Fold per-file max stats over the TRAIN fraction only
    (process_data.py:360-366)."""
    z_min, z_max, zag_max = 1e4, 0.0, 0.0
    uvw_max, p_min, p_max = 0.0, 1e6, 0.0
    n_train = train_ratio * len(names)
    for i, name in enumerate(names):
        if i >= n_train:
            break
        zmn, zmx, zagm, uvwm, pmn, pmx = dfiles.read_max_stats(folder, name)
        z_min = min(z_min, zmn)
        z_max = max(z_max, zmx)
        zag_max = max(zag_max, zagm)
        uvw_max = max(uvw_max, uvwm)
        p_min = min(p_min, pmn)
        p_max = max(p_max, pmx)
    return NormStats(z_min, z_max, zag_max, uvw_max, p_min, p_max)


class WindDataset:
    """Indexable sample source with explicit-RNG slicing/augmentation."""

    def __init__(
        self,
        folder: str,
        names: Sequence[str],
        stats: NormStats,
        x: np.ndarray,
        y: np.ndarray,
        terrain: Optional[np.ndarray] = None,
        coarseness_factor: int = 4,
        include_pressure: bool = False,
        include_z_channel: bool = False,
        include_above_ground_channel: bool = False,
        interpolate_z: bool = False,
        enable_slicing: bool = False,
        slice_size: int = 64,
        data_aug_rot: bool = False,
        data_aug_flip: bool = False,
        is_test: bool = False,
        interp_cache_dir: Optional[str] = None,
    ):
        self.folder = folder
        self.filenames = list(names)
        self.stats = stats
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.terrain = terrain
        self.coarseness_factor = coarseness_factor
        self.include_pressure = include_pressure
        self.include_z_channel = include_z_channel
        self.include_above_ground_channel = include_above_ground_channel
        self.interpolate_z = interpolate_z
        self.enable_slicing = enable_slicing
        self.slice_size = slice_size
        self.data_aug_rot = data_aug_rot
        self.data_aug_flip = data_aug_flip
        self.is_test = is_test
        self.interp_cache_dir = interp_cache_dir or os.path.join(
            folder, "interpolated_z"
        )
        if self.interpolate_z:
            os.makedirs(self.interp_cache_dir, exist_ok=True)
        self._source = None  # optional MemmapSource

    def __len__(self) -> int:
        return len(self.filenames)

    def use_npcache(self) -> None:
        """Switch the loader to the consolidated f32 memmap (npcache.py)."""
        self._source = MemmapSource(self.folder, self.filenames)

    # ---------------------------------------------------------------- load

    def _load(self, name: str):
        if self._source is not None:
            return self._source.load(name)
        return dfiles.read_sample(self.folder, name)

    def _interp_cached(self, name, z, zag, u, v, w, p):
        """z-regrid with a per-sample pickle cache
        (reference download_data.py:360-400)."""
        path = os.path.join(self.interp_cache_dir, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        out = interpolate_z_columns(
            self.x, self.y, np.array(zag), np.array(u), np.array(v),
            np.array(w), np.array(p), self.terrain,
        )
        with open(path, "wb") as f:
            pickle.dump(out, f)
        return out

    # ----------------------------------------------------------------- get

    def _reformat(self, z, zag, u, v, w, p):
        return reformat_sample(
            np.asarray(z), np.asarray(zag), np.asarray(u), np.asarray(v),
            np.asarray(w), np.asarray(p), self.stats,
            coarseness_factor=self.coarseness_factor,
            include_pressure=self.include_pressure,
            include_z_channel=self.include_z_channel,
            include_above_ground_channel=self.include_above_ground_channel,
        )

    def get(self, index: int, rng: np.random.Generator):
        """→ (LR, HR, Z) or, in test mode, (LR, HR, Z, name, HR_raw, Z_raw).

        HR_raw/Z_raw carry the pre-regrid raw-level field when
        ``interpolate_z`` (for raw-grid test metrics), else None.
        """
        name = self.filenames[index]
        z, zag, u, v, w, p = self._load(name)

        hr_raw = z_raw = None
        if self.interpolate_z:
            if self.is_test:
                _, hr_raw, z_raw = self._reformat(z, zag, u, v, w, p)
            z, zag, u, v, w, p = self._interp_cached(name, z, zag, u, v, w, p)

        if self.enable_slicing:
            nx, ny = np.asarray(u).shape[:2]
            xs = round(float(rng.beta(0.25, 0.25)) * (nx - self.slice_size))
            ys = round(float(rng.beta(0.25, 0.25)) * (ny - self.slice_size))
            sl = (
                slice(xs, xs + self.slice_size),
                slice(ys, ys + self.slice_size),
            )
            z, zag, u, v, w, p = (a[sl] for a in (z, zag, u, v, w, p))

        lr, hr, zt = self._reformat(z, zag, u, v, w, p)

        if self.data_aug_rot or self.data_aug_flip:
            lr, hr, zt = augment_sample_np(
                lr, hr, zt, rng, rot=self.data_aug_rot, flip=self.data_aug_flip
            )

        if self.is_test:
            return lr, hr, zt, name[:-4] if name.endswith(".pkl") else name, \
                hr_raw, z_raw
        return lr, hr, zt

    def _skip_draws(self, rng: np.random.Generator) -> None:
        """The random draws ``get`` makes for one sample, without loading
        it: the patch offsets, then the augmentation's."""
        if self.enable_slicing:
            rng.beta(0.25, 0.25)
            rng.beta(0.25, 0.25)
        if self.data_aug_rot:
            rng.integers(0, 4)
        if self.data_aug_flip:
            rng.random()
            rng.random()

    # -------------------------------------------------------------- batches

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        epochs: int = 1,
        drop_remainder: bool = True,
        rows: Optional[slice] = None,
    ):
        """Yield stacked (LR, HR, Z) float32 batches. With ``rows`` (a
        rank's of the data axis) only those rows of each batch are loaded;
        the others' random draws are made all the same, so ``rng`` moves
        as it does for the whole batch."""
        n = len(self.filenames)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n, batch_size):
                idx = order[i : i + batch_size]
                if len(idx) < batch_size and drop_remainder:
                    break
                keep = (range(len(idx)) if rows is None
                        else range(len(idx))[rows])
                items = []
                for b, j in enumerate(idx):
                    if b in keep:
                        items.append(self.get(int(j), rng)[:3])
                    else:
                        self._skip_draws(rng)
                yield tuple(
                    np.stack([it[c] for it in items]) for c in range(3)
                )
