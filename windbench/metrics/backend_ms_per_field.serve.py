"""Serving backend: host time inside ``WindFieldSR.upscale`` calls over
the real fields served in the window."""

from windbench import readers


def read(trace):
    return readers.backend_ms_per_field(trace)
