"""HR head: the device time of the window's ``G.hr_head`` spans (CUDA
events around hr_conv0, whichever computes it) over the real fields
served."""

from windbench import program_spans


def read(trace):
    return program_spans.hr_head_ms_per_field(trace)
