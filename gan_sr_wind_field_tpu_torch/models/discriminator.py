"""Discriminator3D: VGG-style 3D conv discriminator, channels-last.

Counterpart of ``gan_sr_wind_field_tpu/models/discriminator.py``:

- strided blocks 1x → 2x → 4x → 8x (→ 8x) base features, each halving x
  and y; z is halved only where ``remainder_z_layers`` says so;
- ``enable_slicing`` swaps the last block for a shallower head (two
  stride-1 / stride-(1, 1, 2) convs) sized for 64×64 patches;
- batch or instance norm (``norm``) everywhere but the first conv; the
  slicing head's two convs keep batch norm whatever ``norm`` says, as in
  the JAX package (``discriminator.py:90-113``);
- ``conv_mode`` reaches every block and head conv (the window counts of
  a horizontal conv follow the z extent block by block);
- channel dropout → flatten → Linear(→100) → LeakyReLU → Linear(→1) logit.

The flatten is channels-last, (x, y, z, c), as in the JAX package, so
``fc0``'s weight carries over from flax without a permutation. Because
PyTorch has no lazy shapes, the input's x and y extent is given when the
module is built (``spatial``). Returns float32 logits (N,).

On the spatial axis of a mesh (``forward(slab=)``, ``parallel/halo.py``)
the input is this rank's x slab: the blocks run on slabs, each conv with
its x halo, while the slab halves evenly; at the first block whose input
slab would not (and at the latest before the flatten), ``gather_x``
assembles the whole x extent on every rank of the data row, and the rest
runs on that copy, so the flatten is over the whole volume, as in JAX.
``features_only`` returns the features where they are (a slab or the
copy).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gan_sr_wind_field_tpu_torch.models.blocks import (
    BatchNorm,
    ConvLReLU,
    DiscriminatorBlock,
    channel_dropout,
    kaiming_scaled_,
)
from gan_sr_wind_field_tpu_torch.parallel.halo import gather_x


def remainder_z_layers(number_of_z_layers: int):
    """z-extent bookkeeping per block (reference Discriminator_3D.py:55-64)."""
    rem = [number_of_z_layers]
    for i in range(5):
        if i == 0 and number_of_z_layers <= 19:
            rem.append(number_of_z_layers)
        elif i in {1, 2, 3}:
            rem.append(rem[i])
        else:
            rem.append(rem[i] // 2 + rem[i] % 2)
    return rem


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


class Discriminator3D(nn.Module):
    def __init__(self, in_channels: int = 3, base_features: int = 32,
                 feat_kern_size: int = 3, norm: str = "batch",
                 negative_slope: float = 0.2, number_of_z_layers: int = 10,
                 enable_slicing: bool = False,
                 dropout_probability: float = 0.2, init_scale: float = 0.2,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 spatial: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = base_features
        kw = dict(negative_slope=negative_slope, init_scale=init_scale,
                  dtype=dtype, conv_mode=conv_mode, generator=generator)
        specs = [(nf, True, number_of_z_layers > 19), (nf * 2, False, False),
                 (nf * 4, False, False)]
        if enable_slicing:
            specs += [(nf * 8, False, False)]
        else:
            specs += [(nf * 8, False, False), (nf * 8, False, True)]
        X, Y = spatial
        Zl = number_of_z_layers
        blocks, cin = [], in_channels
        for feats, drop_norm, halve_z in specs:
            blocks.append(DiscriminatorBlock(
                cin, feats, feat_kern_size=feat_kern_size, norm=norm,
                drop_first_norm=drop_norm, halve_z=halve_z, z_in=Zl, **kw))
            cin = feats
            X, Y = _out(X, 4, 2, 1), _out(Y, 4, 2, 1)
            Zl = _out(Zl, feat_kern_size, 2 if halve_z else 1, 1)
        self.blocks = nn.ModuleList(blocks)
        if enable_slicing:
            head = dict(kernel_size=feat_kern_size, padding=1, norm="batch",
                        **kw)
            self.head_conv0 = ConvLReLU(cin, nf * 8, strides=1, z_in=Zl,
                                        **head)
            Zl = _out(Zl, feat_kern_size, 1, 1)
            self.head_conv1 = ConvLReLU(nf * 8, nf * 8, strides=(1, 1, 2),
                                        z_in=Zl, **head)
            cin = nf * 8
            Zl = _out(Zl, feat_kern_size, 2, 1)
        self.enable_slicing = enable_slicing
        # the features' (x, y, z, c) extent that fc0 reads, flattened
        self.feature_shape = (X, Y, Zl, cin)
        self.fc0 = nn.Linear(X * Y * Zl * cin, 100)
        self.fc1 = nn.Linear(100, 1)
        for fc in (self.fc0, self.fc1):
            kaiming_scaled_(fc.weight, init_scale, generator)
            nn.init.zeros_(fc.bias)
        self.dropout_probability = dropout_probability
        self.negative_slope = negative_slope
        self.dtype = dtype

    def sync_batch_norm(self, group) -> None:
        """Take every batch norm's train-mode statistics over ``group``'s
        rows and slabs (the mesh's ranks; ``None``: this process's rows
        alone)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False, features_only: bool = False,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                slab=None) -> torch.Tensor:
        """x: (N, X, Y, Z, C), or this rank's x slab of it with ``slab``.
        ``train`` picks batch statistics and channel dropout;
        ``update_stats`` also moves the batch norms' running statistics (in
        place)."""
        x = x.to(self.dtype)
        for blk in self.blocks:
            if slab is not None and x.shape[1] % 2:
                x, slab = gather_x(x, slab), None
            x = blk(x, train, update_stats, slab)
        if self.enable_slicing:
            x = self.head_conv0(x, train, update_stats, slab)
            x = self.head_conv1(x, train, update_stats, slab)
        if features_only:
            return x.float()
        if slab is not None:
            x = gather_x(x, slab)
        p = self.dropout_probability
        if train and p > 0.0:
            x = channel_dropout(x, p, dropout_mask, generator)
        x = x.reshape(x.shape[0], -1)
        dt = self.dtype
        x = F.leaky_relu(F.linear(x, self.fc0.weight.to(dt),
                                  self.fc0.bias.to(dt)), self.negative_slope)
        x = F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        return x.float().squeeze(-1)
