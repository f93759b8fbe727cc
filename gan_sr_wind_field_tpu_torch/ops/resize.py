"""Resampling for channel-last ``(N, X, Y, Z, C)`` volumes."""

from __future__ import annotations

import torch

from gan_sr_wind_field_tpu_torch.parallel.halo import x_window


def decimate_xy(hr: torch.Tensor, factor: int) -> torch.Tensor:
    """Strided decimation ``hr[:, ::f, ::f]``, the reference's LR
    operator."""
    return hr[:, ::factor, ::factor]


def upsample_nearest_xy(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample over x and y of ``(N, X, Y, Z, C)``;
    z is never upscaled (torch ``nn.Upsample(scale_factor=(s, s, 1))``)."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def _linear_resize_align_corners(x: torch.Tensor, out_size: int, axis: int,
                                 window=None) -> torch.Tensor:
    """1D linear resize along ``axis`` with align_corners=True: output i
    samples source position i·(in-1)/(out-1). ``window`` = (in_size,
    in_start, out_start, count): x holds source positions
    ``[in_start, ...)`` of an axis of ``in_size``, and the outputs
    ``[out_start, out_start + count)`` are computed, the same numbers as
    the whole resize's."""
    in_size, in_start, out_start, count = (
        (x.shape[axis], 0, 0, out_size) if window is None else window)
    if out_size == in_size and window is None:
        return x
    x = x.movedim(axis, -1)
    if in_size == 1:
        return x.repeat_interleave(count, dim=-1).movedim(-1, axis)
    pos = (torch.arange(out_start, out_start + count, dtype=torch.float32,
                        device=x.device)
           * (in_size - 1) / (out_size - 1))
    lo = pos.floor().long().clamp(0, in_size - 2)
    w = (pos - lo.float()).to(x.dtype)
    lo = lo - in_start
    out = x[..., lo] * (1.0 - w) + x[..., lo + 1] * w
    return out.movedim(-1, axis)


def upsample_trilinear_xy(lr: torch.Tensor, scale: int,
                          slab=None) -> torch.Tensor:
    """Trilinear align_corners=True upsample of (N, X, Y, Z, C) over x and
    y; with a z scale of 1 and align_corners the z axis is the identity
    (the reference's ``F.interpolate(..., mode='trilinear')`` baseline).
    With a ``slab`` (``parallel/halo.py``) lr is this rank's x slab, which
    takes one neighbour plane on each side, and the output is its HR
    slab."""
    if slab is None:
        out = _linear_resize_align_corners(lr, lr.shape[1] * scale, axis=1)
    else:
        w = lr.shape[1]
        X = w * slab.size
        wide, lo = x_window(lr, slab)
        out = _linear_resize_align_corners(
            wide, X * scale, axis=1,
            window=(X, slab.index * w - lo, slab.index * w * scale,
                    w * scale))
    return _linear_resize_align_corners(out, lr.shape[2] * scale, axis=2)
