"""Evaluation metrics (counterpart of ``gan_sr_wind_field_tpu/ops/metrics.py``).

PSNR keeps the reference's formula: the MSE divides by the spatial volume
times the batch but not by the channels, and the peak is max_diff² = 4
(fields normalised to [-1, 1]).
"""

from __future__ import annotations

import torch


def psnr(hr: torch.Tensor, sr: torch.Tensor, max_diff_squared: float = 4.0,
         epsilon: float = 1e-8) -> torch.Tensor:
    """PSNR in dB of channels-last volumes (N, X, Y, Z, C)."""
    hr, sr = hr.float(), sr.float()
    n, w, h, l = hr.shape[:4]
    mse = ((hr - sr) ** 2).sum() / (w * h * l * n)
    return 10.0 * torch.log10(max_diff_squared / (mse + epsilon))
