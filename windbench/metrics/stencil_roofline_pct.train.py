"""Kernels, kernels 3 and 4 (the gradient stencil and its adjoint):
their bytes bound over their device time."""

from windbench import readers

GRADIENT = "grad_fwd"
ADJOINT = "grad_adj"


def read(trace):
    return readers.stencil_share(trace, GRADIENT, ADJOINT)
