"""Kernels, kernel 1 (the trunk kernel): its least time from the
counted work of the window's served batches over its device time."""

from windbench import readers

KERNELS = ("tc_growth_fwd", "tc_lff_fwd")
PER_RDB = "tc_lff_fwd"


def read(trace):
    return readers.trunk_fwd_share(trace, KERNELS, PER_RDB)
