"""GAN training tricks, with explicit ``torch.Generator``s.

Counterpart of ``gan_sr_wind_field_tpu/train/tricks.py``, reference quirks
kept: instance noise draws from U[0, 1) although the reference's comment
says N(0, 1), scaled by the square root of a linearly annealed variance;
noisy labels are Gaussian-perturbed, then clamped to [0, 1]. The numbers
differ from JAX's for the same seed: tests feed both sides the same noise
or turn it off. The label values and the noise scale may be 0-d tensors,
which a captured CUDA graph reads when it is replayed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def noisy_labels(is_real: bool, batch_size: int, noise_stddev: float = 0.05,
                 true_label_val: float = 1.0, false_label_val: float = 0.0,
                 lower: float = 0.0, upper: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None):
    """Label vector (batch,) = base + Gaussian noise, clamped."""
    base = true_label_val if is_real else false_label_val
    noise = torch.randn(batch_size, generator=generator, device=device)
    return torch.clamp(base + noise * noise_stddev, lower, upper)


def instance_noise_scale(sigma_base: float, it: int, niter: float) -> float:
    """sqrt(σ_base · (1 − (it − 1)/niter)), annealed to zero."""
    return math.sqrt(max(sigma_base * (1.0 - (it - 1.0) / niter), 0.0))


def instance_noise(scale, shape, device=None,
                   generator: Optional[torch.Generator] = None):
    """U[0, 1) · ``scale`` (``instance_noise_scale``, a float or a 0-d
    tensor)."""
    return torch.rand(shape, generator=generator, device=device) * scale
