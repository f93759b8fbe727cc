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
    return psnr_from_mse(mse, max_diff_squared, epsilon)


def psnr_from_mse(mse: torch.Tensor, max_diff_squared: float = 4.0,
                  epsilon: float = 1e-8) -> torch.Tensor:
    """PSNR in dB of ``psnr``'s MSE (a batch's on a mesh: its ranks' shares
    summed)."""
    return 10.0 * torch.log10(max_diff_squared / (mse + epsilon))


def mean_absolute_error(hr: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """Plain L1 (the 'pix' metric of the reference's loss dicts)."""
    return (hr.float() - sr.float()).abs().mean()


def wind_vector_error(hr: torch.Tensor, sr: torch.Tensor,
                      uvw_max: float) -> torch.Tensor:
    """Mean length of the wind-vector error in m/s (reference
    test.py:334-374): hr and sr are normalised (÷ uvw_max)."""
    diff = (hr[..., :3].float() - sr[..., :3].float()) * uvw_max
    return torch.sqrt((diff ** 2).sum(-1)).mean()


def relative_wind_error(hr: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """Mean relative vector error ‖ΔU‖/‖U‖ (reference test.py:334-374)."""
    diff = hr[..., :3].float() - sr[..., :3].float()
    num = torch.sqrt((diff ** 2).sum(-1))
    den = torch.sqrt((hr[..., :3].float() ** 2).sum(-1))
    return (num / (den + 1e-12)).mean()
