"""PyTorch/CUDA port of the wind-field super-resolution generator.

Mirrors ``gan_sr_wind_field_tpu`` module for module. Public tensors keep the
JAX package's channels-last layout ``(N, X, Y, Zl, C)``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; hand-written
CUDA kernels live in ``ops/kernels/csrc`` and are built on first use.
"""

from gan_sr_wind_field_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
