"""Kernels, kernel 2 (the trunk's backward-dx kernel): its least time
from the counted work of the window's G steps over its device time."""

from windbench import readers

KERNELS = ("tc_growth_bwd", "tc_lff_bwd", "bwd_prep", "bwd_mask", "bwd_add")
PER_RDB = "tc_lff_bwd"


def read(trace):
    return readers.trunk_bwd_share(trace, KERNELS, PER_RDB)
