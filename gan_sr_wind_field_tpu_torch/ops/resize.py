"""Resampling for channel-last ``(N, X, Y, Z, C)`` volumes."""

from __future__ import annotations

import torch


def upsample_nearest_xy(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample over x and y of ``(N, X, Y, Z, C)``;
    z is never upscaled (torch ``nn.Upsample(scale_factor=(s, s, 1))``)."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def _linear_resize_align_corners(x: torch.Tensor, out_size: int,
                                 axis: int) -> torch.Tensor:
    """1D linear resize along ``axis`` with align_corners=True: output i
    samples source position i·(in-1)/(out-1)."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    x = x.movedim(axis, -1)
    if in_size == 1:
        return x.repeat_interleave(out_size, dim=-1).movedim(-1, axis)
    pos = (torch.arange(out_size, dtype=torch.float32, device=x.device)
           * (in_size - 1) / (out_size - 1))
    lo = pos.floor().long().clamp(0, in_size - 2)
    w = (pos - lo.float()).to(x.dtype)
    out = x[..., lo] * (1.0 - w) + x[..., lo + 1] * w
    return out.movedim(-1, axis)


def upsample_trilinear_xy(lr: torch.Tensor, scale: int) -> torch.Tensor:
    """Trilinear align_corners=True upsample of (N, X, Y, Z, C) over x and
    y; with a z scale of 1 and align_corners the z axis is the identity
    (the reference's ``F.interpolate(..., mode='trilinear')`` baseline)."""
    out = _linear_resize_align_corners(lr, lr.shape[1] * scale, axis=1)
    return _linear_resize_align_corners(out, lr.shape[2] * scale, axis=2)
