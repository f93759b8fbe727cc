"""The collectives of a step on the data axis, differentiable where the loss
needs them.

JAX has no counterpart: GSPMD inserts these from the sharding annotations.
Each rank's loss is its own share of the global loss (its rows' terms over
the global count), so the sum of the ranks' gradients is the gradient of
the global loss. A value that the loss reads from the whole batch (a mean
of D's logits, a maximum, batch statistics) is computed by a collective
whose forward gives every rank the same value and whose backward sums the
ranks' cotangents of it, so each rank's gradient holds every share's
dependence on its rows. Were every rank to compute the whole loss from
gathered values instead, that backward would count the loss once per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _GroupSum(torch.autograd.Function):
    """all_reduce(SUM) forward; all_reduce(SUM) of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank;
    differentiable (the cotangents of the sum are summed over the group)."""
    return _GroupSum.apply(x, group)


class _GroupAmax(torch.autograd.Function):
    """The maximum of every element of ``x`` on every rank. Its gradient
    reaches only the elements equal to it, on whichever ranks hold them,
    split evenly among them all, as JAX's ``max`` and ``torch.amax`` split
    it among ties."""

    @staticmethod
    def forward(ctx, x, group):
        m = (x.amax() if x.numel() else
             torch.full((), float("-inf"), dtype=x.dtype, device=x.device))
        m = m.reshape(1).clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ctx.group = group
        ctx.save_for_backward(x == m)
        return m.reshape(())

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        # the cotangent summed over the ranks' shares, and the number of
        # maximal elements over the group, in one all_reduce
        both = torch.stack([g.float(), mask.sum().float()])
        dist.all_reduce(both, group=ctx.group)
        return (mask * (both[0] / both[1])).to(g.dtype), None


def group_amax(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum of ``x`` over every rank's elements (a 0-d tensor on
    every rank); differentiable, ties over the group split evenly."""
    return _GroupAmax.apply(x, group)


def group_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean over the group of ``x`` (this rank's rows of a global batch
    of ``n`` rows, ``x.numel() / x.shape[0]`` elements each): the same value
    on every rank, differentiable (``group_sum``). The relativistic-average
    GAN's mean of D's logits."""
    per_row = x.numel() // max(x.shape[0], 1) if x.dim() else 1
    return group_sum(x.sum(), group) / (per_row * n)


def all_reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` over the group, in place, through one flat buffer per
    dtype: one all_reduce per model's gradients a step."""
    tensors = list(tensors)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        with torch.no_grad():
            for t, v in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(v.view_as(t))


def gather_rows(x: torch.Tensor, group, rows: slice, n: int) -> torch.Tensor:
    """The global batch of ``n`` rows from every rank's ``rows`` of it (this
    rank's are ``x``), on every rank: an all_reduce of a zero buffer each
    rank fills at its rows, which NCCL and gloo both take on the card."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[rows] = x
    dist.all_reduce(out, group=group)
    return out
