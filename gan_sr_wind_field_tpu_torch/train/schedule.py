"""Iteration-dependent schedules, pure functions of the iteration ``it``.

Counterpart of ``gan_sr_wind_field_tpu/train/schedule.py``; values are
float32, as the JAX package computes them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 d_g_train_period: int):
    """lr(it) of torch MultiStepLR stepped once per iteration after
    iteration 2·period (the reference's train.py:152): the decay counter at
    ``it`` is max(0, it − 1 − 2·period), and lr = base · gamma^(number of
    milestones ≤ counter)."""
    ms = sorted(int(m) for m in milestones)
    offset = 2 * d_g_train_period + 1

    def fn(it: int) -> float:
        k = sum(m <= max(it - offset, 0) for m in ms)
        return float(np.float32(base_lr) * np.float32(gamma) ** np.float32(k))

    return fn


def label_values(it: int, niter: float, use_one_sided_label_smoothing: bool,
                 flip_labels: bool):
    """(real_label, fake_label, pred_real, pred_fake) at iteration ``it``.
    One-sided smoothing ramps the real label 0.9 → 1.0 (or the fake label
    0.1 → 0.0 when flipped) over training."""
    real, fake = np.float32(1.0), np.float32(0.0)
    itf = np.float32(it)
    if use_one_sided_label_smoothing and flip_labels:
        fake = np.float32(0.1) - np.float32(0.1) * itf / np.float32(niter)
    elif use_one_sided_label_smoothing:
        real = np.float32(0.9) + np.float32(0.1) * itf / np.float32(niter)
    pred_real, pred_fake = (False, True) if flip_labels else (True, False)
    return float(real), float(fake), pred_real, pred_fake
