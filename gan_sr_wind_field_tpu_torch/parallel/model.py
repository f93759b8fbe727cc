"""The model axis: G's output channels over the ranks of a model group.

JAX shards the output-channel dimension of G's convs over the 'model' mesh
axis (``gan_sr_wind_field_tpu/parallel/mesh.py:_param_spec``) and GSPMD
inserts the channel collectives. Here each rank of a model group (the
``tp`` ranks of one data row and one x slab: they hold the same rows and
slab) holds output channels ``[m·O/tp, (m+1)·O/tp)`` of every leaf the
rule shards, dimension 0 of the port's ``(O, I, k…)`` kernels and of the
biases. A sharded conv convolves the whole input with its slice of the
weight, and a gather over the model group gives every model rank the whole
output; everything between convs runs replicated on whole tensors.

The backward is the Megatron pair. Before each sharded conv an identity
whose backward sums the input's cotangent over the model group (each rank's
conv gives only its channels' part of it); after it a gather whose
backward keeps this rank's slice of the whole cotangent (which the
replicated path downstream makes equal on every model rank). With the
pair no loss share changes: a model rank is a replica of the loss, not a
share of it. Summing the gathered tensor's cotangent over the group
instead would count the replicated path ``tp`` times.

The gather is an ``all_reduce`` of a zero-filled buffer that each rank
fills at its channels, as ``parallel/halo.py``'s are: NCCL and gloo take it
on the card as on the CPU, and a sum with zeros is exact, so every model
rank holds the same bits (gloo's ``all_gather`` of CUDA tensors took 1.5x
its time on one card, ``PERF.md`` §6). Faster collectives are later work
(``ROADMAP.md`` §3).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from gan_sr_wind_field_tpu_torch.utils.jax_params import _flax_path


@dataclass(frozen=True)
class Channels:
    """This rank's place on the model axis: the model ``group``, its
    ``index`` in it and the axis's ``size``."""

    group: object
    index: int
    size: int

    def bounds(self, n: int) -> slice:
        """This rank's part of ``n`` output channels; ``n`` must divide."""
        if n % self.size:
            raise ValueError(f"{n} output channels do not divide over a "
                             f"model axis of {self.size}")
        w = n // self.size
        return slice(self.index * w, (self.index + 1) * w)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's output channels (dimension 0) of a whole leaf (a
        copy)."""
        return t[self.bounds(t.shape[0])].clone()


def shards_leaf(key: str, shape, tp: int) -> bool:
    """Whether JAX's ``_param_spec`` gives G's leaf ``key`` (the port's
    name, of the whole ``shape``) a 'model' spec on a model axis of ``tp``:
    a conv kernel (5-D), a dense kernel (2-D) or a bias (1-D) whose output
    count divides ``tp``, and nothing under a batch norm. The rest,
    horizontal_3D's 6-D kernels and hr_conv1's 3 outputs among them, stays
    replicated. The names are JAX's (``utils/jax_params.py:_flax_path``),
    so the port shards exactly the leaves JAX does."""
    if tp <= 1:
        return False
    path = "/".join(_flax_path(key, len(shape)))
    if "BatchNorm" in path or "bn" in path:
        return False
    return len(shape) in (1, 2, 5) and shape[0] % tp == 0


def sharded_keys(params, tp: int) -> frozenset:
    """The keys of G's parameter tree (whole tensors, or anything with a
    ``shape``) that a model axis of ``tp`` shards."""
    return frozenset(k for k, v in params.items()
                     if shards_leaf(k, tuple(v.shape), tp))


def shard_tree(tree, keys, channels: Channels) -> dict:
    """``tree`` with each leaf of ``keys`` cut to this rank's channels."""
    return {k: channels.cut(v) if k in keys else v for k, v in tree.items()}


def gather_trees(trees, keys, channels: Channels) -> list:
    """The whole tensors of the sharded leaves of each tree in ``trees``
    (dicts of this rank's slices), on every model rank: one all_reduce per
    dtype over the model group, each rank filling its channels of a
    zero buffer. Leaves not in ``keys`` are kept as they are."""
    slices = [(i, k, v) for i, tree in enumerate(trees)
              for k, v in tree.items() if k in keys]
    out = [dict(tree) for tree in trees]
    by_dtype = {}
    for item in slices:
        by_dtype.setdefault(item[2].dtype, []).append(item)
    for same in by_dtype.values():
        shapes = [(v.shape[0] * channels.size,) + v.shape[1:]
                  for _, _, v in same]
        flat = same[0][2].new_zeros(sum(torch.Size(s).numel()
                                        for s in shapes))
        wholes = [w.view(s) for w, s in zip(
            flat.split([torch.Size(s).numel() for s in shapes]), shapes)]
        for (_, _, v), w in zip(same, wholes):
            w[channels.index * len(v):(channels.index + 1) * len(v)].copy_(v)
        dist.all_reduce(flat, group=channels.group)
        for (i, k, _), w in zip(same, wholes):
            out[i][k] = w
    return out


class _ToModel(torch.autograd.Function):
    """The identity; backward, the cotangent summed over the model group
    (each rank's sharded conv gives its channels' part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The whole last (channel) dimension from every model rank's part of
    it; backward, this rank's part of the whole cotangent."""

    @staticmethod
    def forward(ctx, y, channels):
        c = y.shape[-1]
        ctx.part = slice(channels.index * c, (channels.index + 1) * c)
        out = y.new_zeros(y.shape[:-1] + (c * channels.size,))
        out[..., ctx.part] = y
        dist.all_reduce(out, group=channels.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.part].contiguous(), None


def to_model(x: torch.Tensor, channels: Channels) -> torch.Tensor:
    """``x``, the whole input of a sharded conv; its gradient is summed
    over the model group (the first of the Megatron pair)."""
    return _ToModel.apply(x, channels.group)


def gather_channels(y: torch.Tensor, channels: Channels) -> torch.Tensor:
    """The whole channels-last tensor from this rank's output channels
    ``y`` (the second of the pair); its gradient is this rank's slice."""
    return _GatherChannels.apply(y.contiguous(), channels)


def sharded_sq_norm(grads, sharded, channels: Channels) -> torch.Tensor:
    """The squared global norm of a gradient list: the leaves flagged in
    ``sharded`` summed over the model group (each rank holds a part), the
    others counted once (every model rank holds the same whole)."""
    parts = [(g.float() ** 2).sum() for g in grads]
    zero = torch.zeros((), device=grads[0].device) if grads else 0.0
    cut = sum((p for p, s in zip(parts, sharded) if s), zero)
    whole = sum((p for p, s in zip(parts, sharded) if not s), zero)
    cut = cut.clone()
    dist.all_reduce(cut, group=channels.group)
    return cut + whole
