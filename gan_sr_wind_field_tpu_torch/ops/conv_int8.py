"""int8 × int8 → int32 3D convolution with a dequantizing epilogue: the
CUDA kernel's wrapper, its host plan, weight packing and the plain
PyTorch version.

The JAX package runs its int8 serving convs as XLA
(``gan_sr_wind_field_tpu/ops/quant.py:conv3d_int8``, int8
``lax.conv_general_dilated`` with int32 accumulation); PyTorch has no int8
conv3d on CUDA, so the port has its own kernel
(``ops/kernels/csrc/conv_int8.cu``). For xq (N, X, Y, Z, ci) int8
channels-last, weights wq (kx, ky, kz, ci, co) int8 (the flax layout, as
the JAX package keeps them) and zero padding (px, py, pz) with 2p = k − 1
per axis, it returns the float32 (N, X, Y, Z, co)

    float(Σ xq · wq) · scale[co]  (+ bias[co])

each operation rounded once, in that order, as JAX's epilogues do
(``astype(f32) * s``, then ``+ b``). ``conv3d_int8`` launches the kernel
for CUDA tensors and takes ``conv3d_int8_reference`` only for CPU tensors.

Packed weights (``pack_conv_int8``): (kx, ky, kz, co, cip) int8, each
output channel's input channels contiguous and zero-padded to cip, a
multiple of 32. ``plan_conv_int8`` gives the tile, grid and shared memory
of a call, and raises for what the kernel does not take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

# kernel launches through `conv3d_int8`
launches = 0

K_SLICE = 32   # input channels per stage: packed weights pad ci to this
X_ALIGN = 16   # the kernel copies 16 bytes: x's channels pad to this
ROW_BYTES = 48  # shared-memory pitch of one 32-byte row


@dataclasses.dataclass(frozen=True)
class ConvInt8Tile:
    """A block of ``csrc/conv_int8.cu`` (``Tile<BM, BN, WARPS_M, WARPS_N,
    NSTAGE>``): bm output rows x bn output channels over warps_m x
    warps_n warps, ``stages`` ring slots of bm + bn rows of 48 bytes."""

    bm: int
    bn: int
    warps_m: int
    warps_n: int
    stages: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_m * self.warps_n

    @property
    def smem_bytes(self) -> int:
        return self.stages * (self.bm + self.bn) * ROW_BYTES


# the instantiations in conv_int8.cu (WideTile, NarrowTile)
WIDE_TILE = ConvInt8Tile(128, 128, 4, 2, 3)
NARROW_TILE = ConvInt8Tile(128, 32, 4, 1, 3)


def _pads(padding) -> tuple:
    if isinstance(padding, int):
        return (padding,) * 3
    return tuple(int(p) for p in padding)


def plan_conv_int8(shape, ci: int, co: int, k, padding) -> dict:
    """The kernel's plan for xq of ``shape`` (N, X, Y, Z, ...), ci input
    and co output channels, kernel extent ``k`` (kx, ky, kz) and padding
    (an int or (px, py, pz)):

    - ``tile`` (``WIDE_TILE`` for co > 32, else ``NARROW_TILE``), ``grid``
      (row blocks, column blocks) and ``smem`` (shared-memory bytes);
    - ``cip``: the packed weights' input channels (ci up to a multiple of
      32) and ``ci_x``: x's channels as the kernel reads them (ci up to a
      multiple of 16; the wrapper pads a copy of x with zeros).

    Raises ValueError for a padding that does not keep the extent
    (2p ≠ k − 1 on an axis), an empty tensor, or rows past the kernel's
    32-bit row index."""
    N, X, Y, Z = (int(v) for v in shape[:4])
    k, pad = tuple(int(v) for v in k), _pads(padding)
    if len(k) != 3 or len(pad) != 3:
        raise ValueError(f"3D kernel and padding, got k={k}, pad={pad}")
    if any(2 * p != kk - 1 for p, kk in zip(pad, k)):
        raise ValueError(f"the int8 conv kernel keeps the extent (2p = k - 1 "
                         f"per axis), got k={k}, padding={pad}")
    if min(N, X, Y, Z, ci, co) < 1:
        raise ValueError(f"empty conv: x {(N, X, Y, Z, ci)}, co {co}")
    rows = N * X * Y * Z
    ci_x = -(-ci // X_ALIGN) * X_ALIGN
    if rows * max(ci_x, 1) >= 2 ** 31 or rows + 2 * Y * Z * max(k) >= 2 ** 31:
        raise ValueError(f"{rows} rows of {ci_x} channels overflow the int8 "
                         "conv kernel's 32-bit row index")
    tile = WIDE_TILE if co > 32 else NARROW_TILE
    return dict(tile=tile,
                grid=(math.ceil(rows / tile.bm), math.ceil(co / tile.bn)),
                smem=tile.smem_bytes, cip=-(-ci // K_SLICE) * K_SLICE,
                ci_x=ci_x)


_plan = functools.lru_cache(maxsize=128)(plan_conv_int8)


def pack_conv_int8(wq: torch.Tensor) -> torch.Tensor:
    """(kx, ky, kz, ci, co) int8 weights as the kernel's (kx, ky, kz, co,
    cip) int8, each output channel's input channels contiguous and
    zero-padded to cip (a multiple of 32)."""
    if wq.dim() != 5 or wq.dtype != torch.int8:
        raise ValueError(f"int8 (kx, ky, kz, ci, co) weights, got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    ci = wq.shape[3]
    cip = -(-ci // K_SLICE) * K_SLICE
    w = wq.permute(0, 1, 2, 4, 3)
    return F.pad(w, (0, cip - ci)).contiguous()


def conv3d_int8_reference(xq: torch.Tensor, wq: torch.Tensor, padding,
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version: ``F.conv3d`` in float64 on the int8 values, exact
    (|acc| ≤ 127² · taps · ci < 2⁵³), cast to int32. With ``scale`` (co,)
    the result is dequantized as the kernel does: float32 acc · scale,
    then + bias; without, the int32 sums are returned."""
    w = wq.to(torch.float64).permute(4, 3, 0, 1, 2)
    acc = F.conv3d(xq.to(torch.float64).permute(0, 4, 1, 2, 3), w,
                   padding=_pads(padding))
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32).contiguous()
    if scale is None:
        return acc
    out = acc.to(torch.float32) * scale.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


_kernels = {}  # ctypes functions by name, typed once when the library loads


def _kernel(name: str):
    if not _kernels:
        from gan_sr_wind_field_tpu_torch.ops.kernels.build import (
            load_library,
        )

        lib = load_library("conv_int8")
        fn = lib.windsr_conv_int8
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        _kernels["conv"] = fn
        smem = lib.windsr_conv_int8_smem
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int]
        _kernels["smem"] = smem
    return _kernels[name]


def kernel_smem(wide: bool) -> int:
    """The shared memory the built kernel's wide (or narrow) tile uses, as
    the library counts it (card tests hold the plan to it)."""
    return int(_kernel("smem")(int(wide)))


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, padding,
                scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 (N, X, Y, Z, co) = float(conv(xq, wq)) · scale (+ bias), for
    xq (N, X, Y, Z, ci) int8 and wq (kx, ky, kz, ci, co) int8: the CUDA
    kernel for CUDA tensors, ``conv3d_int8_reference`` for CPU tensors.
    ``packed`` is ``pack_conv_int8(wq)`` on xq's device; packed on each
    call when not given."""
    global launches
    if xq.device.type == "cpu":
        return conv3d_int8_reference(xq, wq, padding, scale, bias)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    if xq.dim() != 5 or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8 (N, X, Y, Z, ci) input and weights, got "
                         f"{xq.dtype} {tuple(xq.shape)} and {wq.dtype}")
    kx, ky, kz, ci, co = wq.shape
    if xq.shape[-1] != ci:
        raise ValueError(f"x has {xq.shape[-1]} channels, the weights {ci}")
    N, X, Y, Z = xq.shape[:4]
    plan = _plan((N, X, Y, Z), ci, co, (kx, ky, kz), _pads(padding))
    if packed is None:
        packed = pack_conv_int8(wq)
    if (tuple(packed.shape) != (kx, ky, kz, co, plan["cip"])
            or packed.dtype != torch.int8 or not packed.is_contiguous()):
        raise ValueError(f"packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} are not pack_conv_int8 of "
                         f"{tuple(wq.shape)}")
    s = scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    for name, v in (("packed", packed), ("scale", s), ("bias", b)):
        if v is not None and v.device != xq.device:
            raise ValueError(f"{name} is on {v.device}, x on {xq.device}")
    if s.shape != (co,) or (b is not None and b.shape != (co,)):
        raise ValueError(f"scale {tuple(s.shape)} / bias must be ({co},)")
    x = xq.contiguous()
    if plan["ci_x"] != ci:
        x = F.pad(x, (0, plan["ci_x"] - ci))
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the int8 conv kernel copies 16-byte aligned rows")
    card = x.get_device()
    if card != torch.cuda.current_device():
        with torch.cuda.device(card):
            return conv3d_int8(xq, wq, padding, scale, bias, packed)
    out = torch.empty((N, X, Y, Z, co), dtype=torch.float32,
                      device=x.device)
    px, py, pz = _pads(padding)
    rc = _kernel("conv")(
        x.data_ptr(), packed.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(),
        N, X, Y, Z, plan["ci_x"], plan["cip"], co, kx, ky, kz, px, py, pz,
        int(plan["tile"] is WIDE_TILE),
        torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
