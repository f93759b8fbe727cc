"""The spatial axis's collectives: the halo exchange around every conv and
stencil, and D's gather along x.

JAX has no counterpart: GSPMD partitions every conv over the 'spatial' mesh
axis and inserts the halo exchanges from the sharding annotations
(``gan_sr_wind_field_tpu/parallel/mesh.py:volume_sharding``). Here each
rank of a data row holds one x slab ``[i·w, (i+1)·w)`` of every
channels-last (N, X, Y, Z, C) tensor, and a conv whose window reaches
``p`` planes past the slab's edges first widens the slab by those planes
of its neighbours (zeros at the volume's two ends, which is the conv's own
zero padding), then convolves with no x padding.

Both collectives are an ``all_reduce`` over the spatial group of a
zero-filled buffer that each rank fills at its own places: NCCL and gloo
both take it on the card as on the CPU, so one code path serves a run
over NCCL between cards, ranks sharing one card over gloo and the CPU
tests. A sum with zeros is exact, so every value arrives bit for bit. The
halo's buffer has two slots per edge between slabs, (s − 1, 2, ...): the
planes that cross it to the right and those that cross it to the left.
Point-to-point sends (NCCL's ``batch_isend_irecv``) would move
1/(s − 1) of its bytes; that is later work (``ROADMAP.md`` §3).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Slab:
    """This rank's place on the spatial axis: the axis's ``group``, its
    ``index`` on it and the axis's ``size``."""

    group: object
    index: int
    size: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def bounds(self, n: int) -> slice:
        """This rank's x planes of an extent of ``n``; raises ValueError
        when ``n`` does not divide over the axis (GSPMD would pad)."""
        if n % self.size:
            raise ValueError(f"an x extent of {n} does not divide over a "
                             f"spatial axis of {self.size}")
        w = n // self.size
        return slice(self.index * w, (self.index + 1) * w)

    def cut(self, t):
        """This rank's x slab of ``t`` (N, X, ...), a view."""
        return t[:, self.bounds(t.shape[1])]


def _exchange(lo: torch.Tensor, hi: torch.Tensor, slab: "Slab"):
    """Send ``lo`` (planes at this slab's left edge) to the left neighbour
    and ``hi`` (its right edge's) to the right one; → (what the left
    neighbour sent right, what the right one sent left), zeros where the
    volume ends. Slot [j, 0] of the buffer crosses edge j (between slabs
    j and j + 1) to the right, slot [j, 1] to the left."""
    i = slab.index
    buf = lo.new_zeros((slab.size - 1, 2) + tuple(lo.shape))
    if not slab.last:
        buf[i, 0] = hi
    if not slab.first:
        buf[i - 1, 1] = lo
    dist.all_reduce(buf, group=slab.group)
    zero = torch.zeros_like(lo)
    return (zero if slab.first else buf[i - 1, 0],
            zero if slab.last else buf[i, 1])


class _HaloExchange(torch.autograd.Function):
    """Forward: the slab widened by ``width`` planes from each neighbour
    (zeros past the volume's ends). Backward: the halo planes' cotangents
    go back to the neighbour that sent them and add into its edge
    planes."""

    @staticmethod
    def forward(ctx, x, width, slab):
        ctx.width, ctx.slab = width, slab
        left, right = _exchange(x[:, :width], x[:, -width:], slab)
        return torch.cat([left, x, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        width, slab = ctx.width, ctx.slab
        # the halos' cotangents go back: the left halo's to the left
        from_left, from_right = _exchange(g[:, :width], g[:, -width:], slab)
        dx = g[:, width:g.shape[1] - width].clone()
        dx[:, :width] += from_left
        dx[:, -width:] += from_right
        return dx, None, None


def halo_exchange(x: torch.Tensor, width: int, slab: Slab) -> torch.Tensor:
    """``x`` (N, w, ...), this rank's x slab, widened to (N, w + 2·width,
    ...) by ``width`` planes from each neighbour on the spatial axis, with
    zeros at the volume's two ends; differentiable. Raises ValueError for
    a halo wider than the slab (it would need a second neighbour)."""
    if width == 0:
        return x
    if width > x.shape[1]:
        raise ValueError(f"a halo of {width} planes is wider than a slab of "
                         f"{x.shape[1]}")
    return _HaloExchange.apply(x.contiguous(), width, slab)


def x_window(x: torch.Tensor, slab: Slab):
    """The slab widened by one neighbour plane on each side that has one:
    → (the widened tensor, the planes added on the left). At the volume's
    ends nothing is added, so an operator with one-sided ends (the
    nonuniform x derivative, the align-corners resize) sees the true end
    there, and its outputs on ``[left, left + w)`` are the slab's."""
    w = x.shape[1]
    wide = halo_exchange(x, 1, slab)
    lo = 0 if slab.first else 1
    hi = w + 2 - (1 if slab.last else 0)
    return wide[:, 1 - lo:hi], lo


class _GatherX(torch.autograd.Function):
    """All-gather along x over the spatial group; backward the
    reduce-scatter: the cotangents summed over the group, then this rank's
    slab."""

    @staticmethod
    def forward(ctx, x, slab):
        ctx.slab, ctx.w = slab, x.shape[1]
        out = x.new_zeros((x.shape[0], x.shape[1] * slab.size)
                          + tuple(x.shape[2:]))
        out[:, slab.index * x.shape[1]:(slab.index + 1) * x.shape[1]] = x
        dist.all_reduce(out, group=slab.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.slab.group)
        w, i = ctx.w, ctx.slab.index
        return g[:, i * w:(i + 1) * w], None


def gather_x(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The whole x extent of ``x`` (N, w, ...) from every slab of this data
    row, on each of its ranks; differentiable (each slab's gradient is the
    sum of every rank's cotangent of its planes)."""
    return _GatherX.apply(x.contiguous(), slab)
