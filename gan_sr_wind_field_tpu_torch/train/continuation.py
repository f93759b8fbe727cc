"""Numpy-only reader and writer of continuation packs (``.npz`` weight
packs), the weight format the port shares with the JAX package.

Counterpart of ``gan_sr_wind_field_tpu/train/continuation.py``, in its
format: each weight leaf under a ``<tree>/<path...>`` key (trees ``G``,
``D``, ``Dstats``, ``Gema``; the paths of the flax trees, see
``utils/jax_params.py``), bfloat16 leaves bit-cast to ``uint16``, and a
``__meta__`` JSON entry with the format version, the store dtype, ``it``,
each key's original dtype and the trees present. bfloat16 is the upper
half of a float32: it decodes with a shift and encodes by rounding the
float32 bits to nearest even, without ``ml_dtypes``.

    pack_from_state("ckpt.npz", state)          # a port GANTrainState
    pack = load_continuation("ckpt.npz")        # nested flax-layout trees
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_to_jax,
    params_to_jax,
)

FORMAT_VERSION = 1
_TREES = {"G": "params_G", "D": "params_D", "Dstats": "batch_stats_D",
          "Gema": "params_G_ema"}


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """bfloat16 stored as uint16 → float32, exactly."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(a) -> np.ndarray:
    """float32 → bfloat16 bits as uint16, rounded to nearest even on the
    uint32 view, as ``ml_dtypes.bfloat16`` rounds: ±inf and subnormals
    round like any value, and a NaN becomes the quiet NaN of its sign."""
    u = np.asarray(a, np.float32).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    quiet = (u >> 16) & 0x8000 | 0x7FC0
    u = np.where(nan, np.uint32(0), u)  # no NaN pattern can carry over
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16
    return np.where(nan, quiet, rounded).astype(np.uint16)


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    """``<prefix>/<path...>`` keys of a nested dict, keys sorted at every
    level as ``jax.tree_util`` flattens a dict."""
    flat = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}/{key}"))
        else:
            flat[f"{prefix}/{key}"] = np.asarray(val)
    return flat


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


def save_continuation(path: str, params_G, params_D=None, batch_stats_D=None,
                      params_G_ema=None, it: int = 0,
                      store_dtype: str = "bfloat16",
                      extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a pack of flax-layout trees (nested dicts of arrays, as
    ``params_to_jax``/``d_params_to_jax`` give them); → ``path``. Leaves
    are stored in ``store_dtype``: "bfloat16" as rounded uint16 bits, or
    a numpy dtype name."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    trees = {"G": params_G, "D": params_D, "Dstats": batch_stats_D,
             "Gema": params_G_ema}
    for name, tree in trees.items():
        if tree is None:
            continue
        for key, leaf in _flatten(tree, name).items():
            dtypes[key] = str(leaf.dtype)
            arrays[key] = (f32_to_bf16_bits(leaf) if store_dtype == "bfloat16"
                           else leaf.astype(store_dtype))
    meta = {
        "format_version": FORMAT_VERSION,
        "store_dtype": store_dtype,
        "it": int(it),
        "dtypes": dtypes,
        "trees": [n for n, t in trees.items() if t is not None],
    }
    if extra_meta:
        meta.update(extra_meta)
    arrays["__meta__"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    return path


def pack_from_state(path: str, state, it: Optional[int] = None,
                    include_ema: bool = True, store_dtype: str = "bfloat16",
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Pack a port ``GANTrainState``'s weights (G, D, D's statistics and
    the EMA) in the JAX package's tree layout; → ``path``. Empty D
    statistics are left out rather than stored as no keys. The state must
    be whole (``parallel.gather_state`` on a model axis)."""
    if getattr(state, "sharded", None):
        raise ValueError("the state's G is sharded over a model axis: "
                         "gather_state(state, mesh) first")
    params_D, stats = d_params_to_jax({**state.params_D,
                                       **state.batch_stats_D})
    ema = state.params_G_ema if include_ema else None
    return save_continuation(
        path,
        params_G=params_to_jax(state.params_G),
        params_D=params_D,
        batch_stats_D=stats or None,
        params_G_ema=None if ema is None else params_to_jax(ema),
        it=int(state.it) if it is None else it,
        store_dtype=store_dtype,
        extra_meta=extra_meta,
    )
