"""Trainer: the median device time of the window's G iterations, CUDA
events around each ``train_step``."""

from windbench import readers


def read(trace):
    return readers.step_ms(trace, "g_step")
