"""Post-training int8 quantization of the serving head's hr_conv0 x-part.

Counterpart of ``gan_sr_wind_field_tpu/ops/quant.py``, with its scheme and
its numbers:

- per-input-channel activation scales, folded exactly into the kernel
  (the conv contracts over c_in, so ``conv(x, W) == conv(x / s[ci],
  W * s[ci])``);
- per-output-channel symmetric int8 weights on the folded kernel;
- int8 × int8 → int32 sums, dequantized in the conv's epilogue
  (``ops/conv_int8.py``, the port's own CUDA kernel).

Where co > 128 the JAX package splits the kernel as its 128-lane matrix
unit wants: a 128-channel main kernel quantized per output channel, and
the remainder as a 1×1×kz conv with kx·ky·cr stacked output channels,
quantized per stacked channel, whose partial sums are dequantized and
added up over the kx·ky shifts in float32. The split is a TPU shape, but
its scales are the deployed numbers, so the port keeps it: the same int8
weights and scales, the remainder through the same kernel at 1×1×kz and
its shifted sum in float32 torch ops. Same int8 inputs then give the same
int32 sums as JAX; only float summation order can separate the two.

Only the no-grad serving forward uses this (``WindFieldSR.quantize``);
training and validation keep exact numerics. The tensors are the flax
layout (kx, ky, kz, ci, co), as the JAX package keeps them, and
``QuantizedHead`` also carries the kernel's packed forms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gan_sr_wind_field_tpu_torch.ops.conv_int8 import (
    conv3d_int8,
    pack_conv_int8,
)


@dataclasses.dataclass(frozen=True)
class QuantizedHead:
    """Calibrated int8 kernels and scales for hr_conv0's x-part; ``k``,
    ``cm`` and ``cr`` are the split's static geometry, ``packed_*`` the
    kernels in ``pack_conv_int8``'s layout on the same device."""

    s_in: torch.Tensor                    # (ci,) activation scales
    wq_main: torch.Tensor                 # (kx, ky, kz, ci, cm) int8
    s_main: torch.Tensor                  # (cm,)
    wq_rem: Optional[torch.Tensor]        # (1, 1, kz, ci, kx*ky*cr) | None
    s_rem: Optional[torch.Tensor]         # (kx*ky*cr,) | None
    k: Tuple[int, int, int] = (1, 1, 1)
    cm: int = 0
    cr: int = 0
    packed_main: Optional[torch.Tensor] = None
    packed_rem: Optional[torch.Tensor] = None


def fold_quantize_kernel(kernel: torch.Tensor, s_in: torch.Tensor):
    """Per-output-channel int8 quantization of ``kernel * s_in[c_in]``.

    kernel: (kx, ky, kz, ci, co) float; s_in: (ci,) activation scales (x
    is divided by s_in before the conv, so folding multiplies the kernel's
    c_in axis by s_in). Returns (kernel_q int8, s_out (co,) float32)."""
    wf = kernel.to(torch.float32) * s_in.to(torch.float32)[:, None]
    amax = wf.abs().amax(dim=(0, 1, 2, 3))
    s_out = torch.clamp_min(amax, 1e-30) / 127.0
    wq = torch.clamp(torch.round(wf / s_out), -127, 127).to(torch.int8)
    return wq, s_out


def quantize_act(x: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """x / s_in[c] rounded half to even into int8 (the scales come from
    calibration)."""
    xs = x.to(torch.float32) / s_in
    return torch.clamp(torch.round(xs), -127, 127).to(torch.int8)


def quantize_split_head(kernel: torch.Tensor, s_in,
                        lane: int = 128) -> QuantizedHead:
    """Quantize hr_conv0's x-part kernel (kx, ky, kz, ci, co) for
    ``split_head_conv_int8``: a ``cm``-channel main kernel (co rounded down
    to ``lane``) and, where co > cm, the tap-stacked remainder."""
    kx, ky, kz, cin, cout = kernel.shape
    cm = (cout // lane) * lane
    s_in = torch.as_tensor(s_in, dtype=torch.float32,
                           device=kernel.device).reshape(cin)
    if cm == 0 or cm == cout:
        wq, s_out = fold_quantize_kernel(kernel, s_in)
        return QuantizedHead(
            s_in=s_in, wq_main=wq, s_main=s_out, wq_rem=None, s_rem=None,
            k=(kx, ky, kz), cm=int(cout), cr=0,
            packed_main=pack_conv_int8(wq))
    wq, s_out = fold_quantize_kernel(kernel[..., :cm], s_in)
    # the remainder as a z-only conv: (kx, ky, kz, ci, cr) -> (1, 1, kz,
    # ci, kx*ky*cr), quantized per stacked channel (each tap's partial
    # sums are dequantized before the float32 shifted sum)
    cr = cout - cm
    kstack = kernel[..., cm:].permute(2, 3, 0, 1, 4).reshape(
        1, 1, kz, cin, kx * ky * cr)
    wq_r, s_r = fold_quantize_kernel(kstack, s_in)
    return QuantizedHead(
        s_in=s_in, wq_main=wq, s_main=s_out, wq_rem=wq_r, s_rem=s_r,
        k=(kx, ky, kz), cm=int(cm), cr=int(cr),
        packed_main=pack_conv_int8(wq), packed_rem=pack_conv_int8(wq_r))


def split_head_conv_int8(x: torch.Tensor, qh: QuantizedHead, padding: int,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """The int8 serving version of hr_conv0's x-part on x (N, X, Y, Z, ci):
    the same as the float conv with zero padding ``padding`` up to the
    int8 rounding. Two launches of the int8 kernel where the head is
    split (the main conv and the 1×1×kz remainder), one where not."""
    kx, ky, kz = qh.k
    xq = quantize_act(x, qh.s_in)
    main = conv3d_int8(xq, qh.wq_main, padding, qh.s_main,
                       packed=qh.packed_main).to(out_dtype)
    if qh.wq_rem is None:
        return main
    X, Y = x.shape[1], x.shape[2]
    cr = qh.cr
    partial = conv3d_int8(xq, qh.wq_rem, (0, 0, padding), qh.s_rem,
                          packed=qh.packed_rem)
    ppad = F.pad(partial, (0, 0, 0, 0, padding, padding, padding, padding))
    rem = torch.zeros(x.shape[:1] + (X, Y, partial.shape[3], cr),
                      dtype=torch.float32, device=x.device)
    for ix in range(kx):
        for iy in range(ky):
            t0 = (ix * ky + iy) * cr
            rem = rem + ppad[:, ix:ix + X, iy:iy + Y, :, t0:t0 + cr]
    return torch.cat([main, rem.to(out_dtype)], dim=-1)


def head_input_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-channel abs-max over one calibration batch; the caller folds
    batches together on the host (np.maximum over chunks)."""
    return x.to(torch.float32).abs().amax(dim=tuple(range(x.dim() - 1)))


def scales_from_amax(amax) -> torch.Tensor:
    """Symmetric int8 activation scales from calibrated per-channel amax."""
    return torch.clamp_min(torch.as_tensor(amax, dtype=torch.float32),
                           1e-30) / 127.0
