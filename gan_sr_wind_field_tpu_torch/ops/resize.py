"""Resampling for channel-last ``(N, X, Y, Z, C)`` volumes."""

from __future__ import annotations

import torch


def upsample_nearest_xy(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample over x and y of ``(N, X, Y, Z, C)``;
    z is never upscaled (torch ``nn.Upsample(scale_factor=(s, s, 1))``)."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
