"""Whole step: the counted operations of the window's G and D steps
(``counts.g_step_flops``, ``counts.d_step_flops``) over the window's
time, as a share of 989 TFLOP/s."""

from windbench import readers


def read(trace):
    return readers.train_mfu(trace)
