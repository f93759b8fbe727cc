"""Weight bridge: the JAX package's flax generator and discriminator
variables ↔ port ``Generator3D`` / ``Discriminator3D`` state_dicts.

Conv kernels go flax ``(kx, ky, kz, I, O)`` ↔ torch ``(O, I, kx, ky, kz)``,
the inverse of ``gan_sr_wind_field_tpu/utils/torch_import.py:45``. Names
map module by module:

    feature_conv/Conv_0/kernel               ↔ feature_conv.weight
    RRDB{i}/RDB{j}/conv{k}/Conv_0/kernel     ↔ rrdbs.{i}.rdbs.{j}.convs.{k}.weight
    RRDB{i}/RDB{j}/LFF/{kernel,bias}         ↔ rrdbs.{i}.rdbs.{j}.lff.{weight,bias}
    upconv{i}/Conv_0/kernel                  ↔ upconvs.{i}.weight
    hr_conv1/{kernel,bias}                   ↔ hr_conv1.{weight,bias}

The discriminator (``d_params_from_jax`` / ``d_params_to_jax``) carries its
``params`` and its ``batch_stats``:

    block{i}/conv/Conv_0/kernel              ↔ blocks.{i}.conv.weight
    block{i}/strided_conv/BatchNorm_0/scale  ↔ blocks.{i}.strided_conv.bn.scale
    (batch_stats) …/BatchNorm_0/{mean,var}   ↔ ….bn.{mean,var}  (buffers)
    head_conv{i}/…                           ↔ head_conv{i}.…
    fc{i}/{kernel,bias}                      ↔ fc{i}.{weight,bias}

Dense kernels go flax ``(in, out)`` ↔ torch ``(out, in)``; both sides
flatten D's features channels-last, so no other permutation is needed.

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


def _kernel_to_torch(a: np.ndarray) -> np.ndarray:
    return a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T


def _kernel_to_flax(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 4, 1, 0) if a.ndim == 5 else a.T


def _d_key(path) -> str:
    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"block(\d+)", p)
        if m:
            parts += ["blocks", m.group(1)]
        elif p == "BatchNorm_0":
            parts.append("bn")
        elif p != "Conv_0":
            parts.append(p)
    return ".".join(parts + [_LEAF.get(path[-1], path[-1])])


def _d_path(key: str):
    parts = key.split(".")
    path, i = [], 0
    while i < len(parts) - 1:
        if parts[i] == "blocks":
            path.append(f"block{parts[i + 1]}")
            i += 2
            continue
        path.append("BatchNorm_0" if parts[i] == "bn" else parts[i])
        i += 1
    if path[-1] != "BatchNorm_0" and not path[-1].startswith("fc"):
        path.append("Conv_0")  # the flax ConvLReLU wraps its nn.Conv
    return path + [_LEAF_BACK.get(parts[-1], parts[-1])]


def d_params_from_jax(params, batch_stats=None
                      ) -> "OrderedDict[str, torch.Tensor]":
    """flax discriminator params (and batch_stats) → port
    ``Discriminator3D`` state_dict (float32)."""
    sd = OrderedDict()
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree):
            a = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                a = _kernel_to_torch(a)
            sd[_d_key(path)] = torch.tensor(np.ascontiguousarray(a))
    return sd


def d_params_to_jax(state_dict):
    """port ``Discriminator3D`` state_dict → (flax params, batch_stats)."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        path = _d_path(key)
        if path[-1] == "kernel":
            a = _kernel_to_flax(a)
        node = stats if path[-1] in ("mean", "var") else params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return params, stats
