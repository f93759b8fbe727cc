"""Consolidated float32 memmap sample cache (the port's own copy of
``gan_sr_wind_field_tpu/data/npcache.py``: the same file for the same
names).

Per-sample pickle loads (the reference's hot-path IO, process_data.py:111-118)
cost a file open + unpickle + f64→f32 cast per item. The host must
assemble batches faster than the device steps, so the loop
consolidates each split's samples once into a single memory-mapped f32 array
of shape (n_samples, 6, nx, ny, nz) — batch assembly becomes pure memcpy
from page cache, zero deserialization.

The cache file is keyed by the exact name list (split-specific) and is
idempotent to rebuild.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence, Tuple

import numpy as np

from gan_sr_wind_field_tpu_torch.data import files as dfiles

_FIELDS = 6  # z, z_above_ground, u, v, w, pressure


def _cache_key(names: Sequence[str]) -> str:
    h = hashlib.sha1("|".join(names).encode()).hexdigest()
    return h[:16]


def build_memmap_cache(folder: str, names: Sequence[str]) -> str:
    """Consolidate ``names`` pickles into one memmap; → its path.

    Idempotent: returns immediately when the cache already exists.
    """
    key = _cache_key(names)
    path = os.path.join(folder, f"npcache_{key}.f32")
    meta_path = path + ".json"
    if os.path.isfile(path) and os.path.isfile(meta_path):
        return path

    first = dfiles.read_sample(folder, names[0])
    shape = (len(names), _FIELDS) + np.asarray(first[0]).shape
    arr = np.lib.format.open_memmap(
        path + ".tmp", mode="w+", dtype=np.float32, shape=shape
    )
    for i, name in enumerate(names):
        sample = first if i == 0 else dfiles.read_sample(folder, name)
        for c in range(_FIELDS):
            arr[i, c] = np.asarray(sample[c], np.float32)
    arr.flush()
    del arr
    os.replace(path + ".tmp", path)
    with open(meta_path, "w") as f:
        json.dump({"shape": shape, "names": list(names)}, f)
    return path


class MemmapSource:
    """Zero-copy loader over the consolidated cache."""

    def __init__(self, folder: str, names: Sequence[str]):
        self.path = build_memmap_cache(folder, names)
        self._arr = np.load(self.path, mmap_mode="r")
        self._index = {n: i for i, n in enumerate(names)}

    def load(self, name: str) -> Tuple[np.ndarray, ...]:
        """→ (z, zag, u, v, w, p) float32 views into the memmap."""
        row = self._arr[self._index[name]]
        return tuple(row[c] for c in range(_FIELDS))
