"""Whole step: the counted operations of the real volumes' forwards
over the time inside the backend calls, as a share of 989 TFLOP/s."""

from windbench import readers


def read(trace):
    return readers.serve_mfu(trace)
