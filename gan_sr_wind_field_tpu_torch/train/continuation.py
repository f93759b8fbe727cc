"""Numpy-only reader for continuation packs (``.npz`` weight packs).

The format is written by ``gan_sr_wind_field_tpu/train/continuation.py``:
each weight leaf under a ``<tree>/<path...>`` key (trees ``G``, ``D``,
``Dstats``, ``Gema``), bfloat16 leaves bit-cast to ``uint16``, and a
``__meta__`` JSON entry with the format version and ``it``. bfloat16 is
the upper half of a float32, so it decodes with a shift, without
``ml_dtypes``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

FORMAT_VERSION = 1
_TREES = {"G": "params_G", "D": "params_D", "Dstats": "batch_stats_D",
          "Gema": "params_G_ema"}


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """bfloat16 stored as uint16 → float32, exactly."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_continuation(path: str, dtype: str = "float32") -> Dict[str, Any]:
    """Load a pack: ``params_G``, ``params_D``, ``batch_stats_D`` and
    ``params_G_ema`` as nested dicts of numpy arrays in ``dtype`` (None when
    the pack lacks the tree), ``it``, and the raw ``meta`` dict."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"continuation pack {path} has format "
                f"{meta['format_version']} > supported {FORMAT_VERSION}"
            )
        store_bf16 = meta.get("store_dtype") == "bfloat16"
        per_tree: Dict[str, Dict[str, np.ndarray]] = {t: {} for t in _TREES}
        for key in z.files:
            if key == "__meta__":
                continue
            tree_name, rest = key.split("/", 1)
            leaf = z[key]
            if store_bf16 and leaf.dtype == np.uint16:
                leaf = bf16_bits_to_f32(leaf)
            per_tree[tree_name][rest] = leaf.astype(dtype)
    out: Dict[str, Any] = {"it": int(meta.get("it", 0)), "meta": meta}
    for tree_name, out_key in _TREES.items():
        flat = per_tree[tree_name]
        out[out_key] = _unflatten(flat) if flat else None
    return out
