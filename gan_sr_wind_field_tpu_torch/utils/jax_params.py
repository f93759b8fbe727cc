"""Weight bridge: the JAX package's flax generator params ↔ a port
``Generator3D`` state_dict.

Conv kernels go flax ``(kx, ky, kz, I, O)`` ↔ torch ``(O, I, kx, ky, kz)``,
the inverse of ``gan_sr_wind_field_tpu/utils/torch_import.py:45``. Names
map module by module:

    feature_conv/Conv_0/kernel               ↔ feature_conv.weight
    RRDB{i}/RDB{j}/conv{k}/Conv_0/kernel     ↔ rrdbs.{i}.rdbs.{j}.convs.{k}.weight
    RRDB{i}/RDB{j}/LFF/{kernel,bias}         ↔ rrdbs.{i}.rdbs.{j}.lff.{weight,bias}
    upconv{i}/Conv_0/kernel                  ↔ upconvs.{i}.weight
    hr_conv1/{kernel,bias}                   ↔ hr_conv1.{weight,bias}

Flax trees are nested dicts of arrays (numpy, or anything ``np.asarray``
takes); nothing here imports JAX.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_INDEXED = {"RRDB": "rrdbs", "RDB": "rdbs", "conv": "convs",
            "upconv": "upconvs"}
_INDEXED_BACK = {v: k for k, v in _INDEXED.items()}
_LEAF = {"kernel": "weight", "bias": "bias"}
_LEAF_BACK = {v: k for k, v in _LEAF.items()}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_key(path) -> str:
    parts = []
    for p in path[:-1]:
        if p == "Conv_0":
            continue
        m = re.fullmatch(r"([A-Za-z]+)(\d+)", p)
        if m and m.group(1) in _INDEXED:
            parts += [_INDEXED[m.group(1)], m.group(2)]
        else:
            parts.append(p.lower() if p == "LFF" else p)
    return ".".join(parts + [_LEAF[path[-1]]])


def _flax_path(key: str):
    parts = key.split(".")
    path, i = [], 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in _INDEXED_BACK:
            path.append(f"{_INDEXED_BACK[p]}{parts[i + 1]}")
            i += 2
        else:
            path.append("LFF" if p == "lff" else p)
            i += 1
    # blocks built from the flax ConvLReLU wrap their nn.Conv as Conv_0;
    # LFF and the hr convs are bare nn.Conv
    owner = path[-1]
    if not (owner == "LFF" or owner.startswith("hr_conv")):
        path.append("Conv_0")
    return path + [_LEAF_BACK[parts[-1]]]


def params_from_jax(tree) -> "OrderedDict[str, torch.Tensor]":
    """flax generator params → port ``Generator3D`` state_dict (float32)."""
    sd = OrderedDict()
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(4, 3, 0, 1, 2)
        sd[_torch_key(path)] = torch.tensor(np.ascontiguousarray(a))
    return sd


def params_to_jax(state_dict) -> dict:
    """port ``Generator3D`` state_dict → flax generator params (numpy)."""
    tree: dict = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        path = _flax_path(key)
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 4, 1, 0)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree
