"""int8 × int8 → int32 3D convolutions with their epilogues: the CUDA
kernels' wrappers, their host plans, weight packing and the plain PyTorch
versions.

The JAX package runs its int8 serving convs as XLA
(``gan_sr_wind_field_tpu/ops/quant.py:conv3d_int8``, int8
``lax.conv_general_dilated`` with int32 accumulation); PyTorch has no int8
conv3d on CUDA, so the port has its own kernel
(``ops/kernels/csrc/conv_int8.cu``, wgmma). For xq (N, X, Y, Z, ci) int8
channels-last, weights wq (kx, ky, kz, ci, co) int8 (the flax layout, as
the JAX package keeps them) and zero padding (px, py, pz) with 2p = k − 1
per axis, the int32 sums are exact, and three entry points finish them,
each float operation rounded once, in JAX's order:

- ``conv3d_int8``: float32 ``float(Σ xq · wq) · scale (+ bias)`` (the
  LFF's epilogue, ``astype(f32) * s``, then ``+ b``);
- ``head_pair_int8``: the int8 head's main conv and its 1×1×kz remainder
  in one launch, the main conv's ``float(acc) · s_main`` rounded to the
  head's dtype into the first columns of the head's output, the
  remainder's float32 partials beside it;
- ``conv3d_int8_requant``: a trunk growth conv that reads the first ci
  channels of the RDB step's int8 concat buffer and writes
  ``quantize_act(leaky_relu(float(acc) · scale), s_out)`` into its own
  columns of it.

Each launches its kernel for CUDA tensors and takes its plain version
(``conv3d_int8_reference``, ``head_pair_int8_reference``,
``conv3d_int8_requant_reference``) only for CPU tensors.

Packed weights (``pack_conv_int8``): (kx, ky, kz, co, cip) int8, each
output channel's input channels contiguous and zero-padded to cip, a
multiple of 32. The plans (``plan_conv_int8``, ``plan_head_pair_int8``,
``plan_conv_int8_requant``) give the tiles, grid and shared memory of a
call, and raise for what the kernels do not take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

# kernel launches through `conv3d_int8`, `head_pair_int8` and
# `conv3d_int8_requant`
launches = 0
pair_launches = 0
requant_launches = 0

K_SLICE = 32    # channels per wgmma k step: packed weights pad ci to this
X_ALIGN = 16    # the kernel copies 16 bytes: x's channels pad to this
ROW_BYTES = 64  # a window row: one 64-channel slice
ZERO_BYTES = 64
MAX_K = 5       # kernel extent per axis (odd: 1, 3 or 5)
SMEM_LIMIT = 232448  # a block's shared memory on sm_90


@dataclasses.dataclass(frozen=True)
class ConvInt8Tile:
    """A block of ``csrc/conv_int8.cu`` (``Tile<BM, BN, WG, NSTAGE, DYS>``):
    bm output rows x bn output channels over ``warpgroups`` warpgroups,
    ``stages`` weight slots of ``dys`` kernel rows x kz taps x 64 bytes x
    bn, and the input windows of bm + 2 (py Z + pz) rows of 64 bytes."""

    bm: int
    bn: int
    warpgroups: int
    stages: int
    dys: int

    @property
    def threads(self) -> int:
        return 128 * self.warpgroups

    def windows(self, ky: int) -> int:
        """Window buffers: two where a window (a 64-channel slice and dx,
        ceil(ky / dys) stages) lasts the ring's lead of stages - 1
        stages, else one per slot."""
        return 2 if self.stages <= -(-ky // self.dys) + 1 else self.stages

    def slot_bytes(self, ky: int, kz: int) -> int:
        return min(self.dys, ky) * kz * ROW_BYTES * self.bn

    def smem_bytes(self, Z: int, k, pad) -> int:
        """Shared memory for a call of depth Z, extent k = (kx, ky, kz) and
        padding pad = (px, py, pz)."""
        halo = self.bm + 2 * (pad[1] * Z + pad[2])
        return (self.stages * self.slot_bytes(k[1], k[2])
                + self.windows(k[1]) * halo * ROW_BYTES + ZERO_BYTES)


# the instantiations in conv_int8.cu (HeadTile, RemTile, WideTile,
# NarrowTile); TILES in the order of windsr_conv_int8_smem's `which`
HEAD_TILE = ConvInt8Tile(256, 128, 4, 3, 1)
REM_TILE = ConvInt8Tile(256, 80, 4, 3, 1)
WIDE_TILE = ConvInt8Tile(64, 128, 1, 3, 1)
NARROW_TILE = ConvInt8Tile(128, 32, 2, 3, 3)
TILES = (NARROW_TILE, WIDE_TILE, HEAD_TILE, REM_TILE)


def _pads(padding) -> tuple:
    if isinstance(padding, int):
        return (padding,) * 3
    return tuple(int(p) for p in padding)


def _geometry(shape, ci: int, co: int, k, padding) -> tuple:
    """(N, X, Y, Z), k, pad, rows, ci_x, cip of a call; raises ValueError
    for what no entry point takes."""
    N, X, Y, Z = (int(v) for v in shape[:4])
    k, pad = tuple(int(v) for v in k), _pads(padding)
    if len(k) != 3 or len(pad) != 3:
        raise ValueError(f"3D kernel and padding, got k={k}, pad={pad}")
    if any(2 * p != kk - 1 for p, kk in zip(pad, k)):
        raise ValueError(f"the int8 conv kernel keeps the extent (2p = k - 1 "
                         f"per axis), got k={k}, padding={pad}")
    if max(k) > MAX_K:
        raise ValueError(f"the int8 conv kernel takes kernel extents up to "
                         f"{MAX_K} per axis, got k={k}")
    if min(N, X, Y, Z, ci, co) < 1:
        raise ValueError(f"empty conv: x {(N, X, Y, Z, ci)}, co {co}")
    rows = N * X * Y * Z
    ci_x = -(-ci // X_ALIGN) * X_ALIGN
    if rows * max(ci_x, 1) >= 2 ** 31 or rows + 2 * Y * Z * max(k) >= 2 ** 31:
        raise ValueError(f"{rows} rows of {ci_x} channels overflow the int8 "
                         "conv kernel's 32-bit row index")
    return (N, X, Y, Z), k, pad, rows, ci_x, -(-ci // K_SLICE) * K_SLICE


def _smem(tile: ConvInt8Tile, Z: int, k, pad) -> int:
    smem = tile.smem_bytes(Z, k, pad)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the int8 conv kernel's {tile} needs {smem} bytes of "
                         f"shared memory at Z={Z}, k={k}: past the block's "
                         f"{SMEM_LIMIT}")
    return smem


def plan_conv_int8(shape, ci: int, co: int, k, padding) -> dict:
    """``conv3d_int8``'s plan for xq of ``shape`` (N, X, Y, Z, ...), ci input
    and co output channels, kernel extent ``k`` (kx, ky, kz) and padding
    (an int or (px, py, pz)):

    - ``tile`` (``WIDE_TILE`` for co > 32, else ``NARROW_TILE``), ``grid``
      (row blocks, column blocks) and ``smem`` (shared-memory bytes);
    - ``cip``: the packed weights' input channels (ci up to a multiple of
      32) and ``ci_x``: x's channels as the kernel reads them (ci up to a
      multiple of 16; the wrapper pads a copy of x with zeros).

    Raises ValueError for a padding that does not keep the extent
    (2p ≠ k − 1 on an axis), an extent past 5, an empty tensor, rows past
    the kernel's 32-bit row index, or windows past a block's shared
    memory."""
    (N, X, Y, Z), k, pad, rows, ci_x, cip = _geometry(shape, ci, co, k,
                                                      padding)
    tile = WIDE_TILE if co > 32 else NARROW_TILE
    return dict(tile=tile,
                grid=(math.ceil(rows / tile.bm), math.ceil(co / tile.bn)),
                smem=_smem(tile, Z, k, pad), cip=cip, ci_x=ci_x)


def plan_head_pair_int8(shape, ci: int, cm: int, cr: int, k,
                        padding) -> dict:
    """``head_pair_int8``'s plan: one launch over 256-row blocks whose
    column blocks are the main conv's (extent k, padding, ci -> cm) chunks
    of 128 (``HEAD_TILE``) and then, where cr > 0, the 1×1×kz remainder's
    (ci -> cr stacked channels) chunks of 80 (``REM_TILE``): ``grid`` (row
    blocks, main chunks + remainder chunks), ``smem`` (the larger of the
    two tiles'), ``cip``, ``ci_x``; raises as ``plan_conv_int8``."""
    (N, X, Y, Z), k, pad, rows, ci_x, cip = _geometry(shape, ci, cm, k,
                                                      padding)
    smem = _smem(HEAD_TILE, Z, k, pad)
    chunks = math.ceil(cm / HEAD_TILE.bn)
    if cr > 0:
        smem = max(smem, _smem(REM_TILE, Z, (1, 1, k[2]), (0, 0, pad[2])))
        chunks += math.ceil(cr / REM_TILE.bn)
    return dict(main=HEAD_TILE, rem=REM_TILE if cr > 0 else None,
                grid=(math.ceil(rows / HEAD_TILE.bm), chunks), smem=smem,
                cip=cip, ci_x=ci_x)


def plan_conv_int8_requant(shape, ci: int, co: int, k, padding, ldx: int,
                           ldo: int, col: int) -> dict:
    """``conv3d_int8_requant``'s plan for an input of rows of ``ldx``
    channels whose first ci are the conv's, and an int8 output of rows of
    ``ldo`` channels written at columns [col, col + co): ``tile``
    (``NARROW_TILE``), ``grid``, ``smem``, ``cip``. Raises ValueError, as
    ``plan_conv_int8`` and for a pitch or offset the kernel does not take:
    ci or ldx not a multiple of 16, ci past ldx, columns past ldo."""
    if ci % X_ALIGN or ldx % X_ALIGN or ci > ldx:
        raise ValueError(f"the requantizing int8 conv reads 16-byte chunks: "
                         f"ci ({ci}) and the input pitch ({ldx}) must be "
                         f"multiples of {X_ALIGN}, ci within the pitch")
    if col < 0 or col + co > ldo:
        raise ValueError(f"output columns [{col}, {col + co}) do not fit the "
                         f"output pitch {ldo} (offset {col})")
    (N, X, Y, Z), k, pad, rows, _, cip = _geometry(shape, ci, co, k, padding)
    tile = NARROW_TILE
    return dict(tile=tile,
                grid=(math.ceil(rows / tile.bm), math.ceil(co / tile.bn)),
                smem=_smem(tile, Z, k, pad), cip=cip)


_plan = functools.lru_cache(maxsize=128)(plan_conv_int8)
_plan_pair = functools.lru_cache(maxsize=32)(plan_head_pair_int8)
_plan_requant = functools.lru_cache(maxsize=128)(plan_conv_int8_requant)


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


def head_pair_int8_reference(xq: torch.Tensor, wq_main: torch.Tensor,
                             s_main: torch.Tensor, padding: int,
                             wq_rem: Optional[torch.Tensor] = None,
                             s_rem: Optional[torch.Tensor] = None, *,
                             width: Optional[int] = None,
                             out_dtype: torch.dtype = torch.bfloat16):
    """Plain version of ``head_pair_int8``: the main conv dequantized and
    cast to ``out_dtype`` into columns [0, cm) of a new (N, X, Y, Z,
    width) tensor (the rest left for the caller), and the remainder's
    float32 partials (``conv3d_int8_reference`` at (0, 0, pz)) or None."""
    main = conv3d_int8_reference(xq, wq_main, padding, s_main).to(out_dtype)
    cm = main.shape[-1]
    out = torch.empty((*main.shape[:4], cm if width is None else width),
                      dtype=out_dtype, device=xq.device)
    out[..., :cm] = main
    if wq_rem is None:
        return out, None
    pz = _pads(padding)[2]
    return out, conv3d_int8_reference(xq, wq_rem, (0, 0, pz), s_rem)


def conv3d_int8_requant_reference(xq: torch.Tensor, ci: int,
                                  wq: torch.Tensor, padding,
                                  scale: torch.Tensor, s_out: torch.Tensor,
                                  negative_slope: float, out: torch.Tensor,
                                  col: int) -> torch.Tensor:
    """Plain version of ``conv3d_int8_requant``: ``quantize_act`` of
    ``leaky_relu`` of the dequantized conv of xq's first ci channels,
    written into out[..., col:col + co]; returns out."""
    from gan_sr_wind_field_tpu_torch.ops.quant import quantize_act

    c = conv3d_int8_reference(xq[..., :ci], wq, padding, scale)
    out[..., col:col + c.shape[-1]] = quantize_act(
        F.leaky_relu(c, negative_slope), s_out)
    return out


_kernels = {}  # ctypes functions by name, typed once when the library loads


def _kernel(name: str):
    if not _kernels:
        from gan_sr_wind_field_tpu_torch.ops.kernels.build import (
            load_library,
        )

        lib = load_library("conv_int8")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, key, args in (
                ("windsr_conv_int8", "conv", [p] * 5 + [i] * 14 + [p]),
                ("windsr_conv_int8_requant", "requant",
                 [p, i, p, p, p, ctypes.c_float, p, i, i] + [i] * 13 + [p]),
                ("windsr_head_pair_int8", "pair",
                 [p, p, p, p, i, i, p, p, p] + [i] * 14 + [p])):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = args
            _kernels[key] = f
        smem = lib.windsr_conv_int8_smem
        smem.restype = ctypes.c_longlong
        smem.argtypes = [i] * 6
        _kernels["smem"] = smem
    return _kernels[name]


def kernel_smem(tile: ConvInt8Tile, Z: int, k, padding) -> int:
    """The shared memory the built kernel's ``tile`` uses for a call of
    depth Z, extent k and padding, as the library counts it (card tests
    hold the plans to it)."""
    pad = _pads(padding)
    return int(_kernel("smem")(TILES.index(tile), Z, k[1], k[2], pad[1],
                               pad[2]))


def _on_card(xq: torch.Tensor, *tensors) -> int:
    """The card of xq, after checking that every tensor given is on it."""
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    for name, v in tensors:
        if v is not None and v.device != xq.device:
            raise ValueError(f"{name} is on {v.device}, x on {xq.device}")
    return xq.get_device()


def _check_int8(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dim() != 5 or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8 (N, X, Y, Z, ci) input and weights, got "
                         f"{xq.dtype} {tuple(xq.shape)} and {wq.dtype}")


def _check_packed(packed, wq, cip):
    kx, ky, kz, _, co = wq.shape
    if (tuple(packed.shape) != (kx, ky, kz, co, cip)
            or packed.dtype != torch.int8 or not packed.is_contiguous()):
        raise ValueError(f"packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} are not pack_conv_int8 of "
                         f"{tuple(wq.shape)}")


def _scale(v: torch.Tensor, co: int, name: str) -> torch.Tensor:
    v = v.to(torch.float32).contiguous()
    if v.shape != (co,):
        raise ValueError(f"{name} {tuple(v.shape)} must be ({co},)")
    return v


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


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
    _check_int8(xq, wq)
    kx, ky, kz, ci, co = wq.shape
    if xq.shape[-1] != ci:
        raise ValueError(f"x has {xq.shape[-1]} channels, the weights {ci}")
    N, X, Y, Z = xq.shape[:4]
    plan = _plan((N, X, Y, Z), ci, co, (kx, ky, kz), _pads(padding))
    if packed is None:
        packed = pack_conv_int8(wq)
    _check_packed(packed, wq, plan["cip"])
    s = _scale(scale, co, "scale")
    b = None if bias is None else _scale(bias, co, "bias")
    card = _on_card(xq, ("packed", packed), ("scale", s), ("bias", b))
    x = xq.contiguous()
    if plan["ci_x"] != ci:
        x = F.pad(x, (0, plan["ci_x"] - ci))
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the int8 conv kernel copies 16-byte aligned rows")
    if card != torch.cuda.current_device():
        with torch.cuda.device(card):
            return conv3d_int8(xq, wq, padding, scale, bias, packed)
    out = torch.empty((N, X, Y, Z, co), dtype=torch.float32,
                      device=x.device)
    px, py, pz = _pads(padding)
    _rc(_kernel("conv")(
        x.data_ptr(), packed.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(),
        N, X, Y, Z, plan["ci_x"], plan["cip"], co, kx, ky, kz, px, py, pz,
        int(plan["tile"] is WIDE_TILE),
        torch._C._cuda_getCurrentRawStream(card)), "int8 conv kernel")
    launches += 1
    return out


def head_pair_int8(xq: torch.Tensor, wq_main: torch.Tensor,
                   s_main: torch.Tensor, padding: int,
                   wq_rem: Optional[torch.Tensor] = None,
                   s_rem: Optional[torch.Tensor] = None, *,
                   width: Optional[int] = None,
                   out_dtype: torch.dtype = torch.bfloat16,
                   packed_main: Optional[torch.Tensor] = None,
                   packed_rem: Optional[torch.Tensor] = None):
    """The int8 head's convs on one input xq (N, X, Y, Z, ci) in one
    launch: the main conv (wq_main (kx, ky, kz, ci, cm), zero padding
    ``padding``) dequantized by s_main and rounded to ``out_dtype``
    (bfloat16 or float32) into columns [0, cm) of a new (N, X, Y, Z,
    width) tensor (width defaults to cm; the caller fills the rest) and,
    where wq_rem (1, 1, kz, ci, cr) is given, the remainder's float32
    partials float(acc) · s_rem (N, X, Y, Z, cr) at padding (0, 0, pz).
    Returns (out, partials or None). The CUDA kernel for CUDA tensors,
    ``head_pair_int8_reference`` for CPU tensors; ``packed_*`` are
    ``pack_conv_int8`` of the weights, packed on each call when not
    given."""
    global pair_launches
    if xq.device.type == "cpu":
        return head_pair_int8_reference(xq, wq_main, s_main, padding, wq_rem,
                                        s_rem, width=width,
                                        out_dtype=out_dtype)
    _check_int8(xq, wq_main)
    kx, ky, kz, ci, cm = wq_main.shape
    pad = _pads(padding)
    width = cm if width is None else int(width)
    cr = 0
    if wq_rem is not None:
        _check_int8(xq, wq_rem)
        if tuple(wq_rem.shape[:4]) != (1, 1, kz, ci):
            raise ValueError(f"remainder weights {tuple(wq_rem.shape)} are "
                             f"not (1, 1, {kz}, {ci}, cr)")
        cr = wq_rem.shape[4]
    if xq.shape[-1] != ci:
        raise ValueError(f"x has {xq.shape[-1]} channels, the weights {ci}")
    if width < cm or out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"a bfloat16 or float32 output of at least {cm} "
                         f"columns, got {out_dtype} of {width}")
    N, X, Y, Z = xq.shape[:4]
    plan = _plan_pair((N, X, Y, Z), ci, cm, cr, (kx, ky, kz), pad)
    if packed_main is None:
        packed_main = pack_conv_int8(wq_main)
    _check_packed(packed_main, wq_main, plan["cip"])
    sm = _scale(s_main, cm, "s_main")
    sr = None
    if cr:
        if packed_rem is None:
            packed_rem = pack_conv_int8(wq_rem)
        _check_packed(packed_rem, wq_rem, plan["cip"])
        sr = _scale(s_rem, cr, "s_rem")
    card = _on_card(xq, ("packed_main", packed_main), ("s_main", sm),
                    ("packed_rem", packed_rem if cr else None),
                    ("s_rem", sr))
    x = xq.contiguous()
    if plan["ci_x"] != ci:
        x = F.pad(x, (0, plan["ci_x"] - ci))
    if x.data_ptr() % 16:
        raise ValueError("the int8 conv kernel copies 16-byte aligned rows")
    if card != torch.cuda.current_device():
        with torch.cuda.device(card):
            return head_pair_int8(xq, wq_main, s_main, padding, wq_rem, s_rem,
                                  width=width, out_dtype=out_dtype,
                                  packed_main=packed_main,
                                  packed_rem=packed_rem)
    out = torch.empty((N, X, Y, Z, width), dtype=out_dtype, device=x.device)
    partial = (torch.empty((N, X, Y, Z, cr), dtype=torch.float32,
                           device=x.device) if cr else None)
    _rc(_kernel("pair")(
        x.data_ptr(), packed_main.data_ptr(), sm.data_ptr(), out.data_ptr(),
        width, int(out_dtype == torch.bfloat16),
        packed_rem.data_ptr() if cr else None,
        sr.data_ptr() if cr else None,
        partial.data_ptr() if cr else None,
        N, X, Y, Z, plan["ci_x"], plan["cip"], cm, cr, kx, ky, kz, *pad,
        torch._C._cuda_getCurrentRawStream(card)), "int8 head pair kernel")
    pair_launches += 1
    return out, partial


def conv3d_int8_requant(xq: torch.Tensor, ci: int, wq: torch.Tensor,
                        padding, scale: torch.Tensor, s_out: torch.Tensor,
                        negative_slope: float, out: torch.Tensor, col: int,
                        packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """A trunk growth conv into its concat buffer: the conv (wq (kx, ky,
    kz, ci, co)) of the first ci channels of xq (N, X, Y, Z, P) int8,
    ``quantize_act(leaky_relu(float(acc) · scale, negative_slope),
    s_out)`` written into out[..., col:col + co] (out (N, X, Y, Z, Q)
    int8, contiguous; it may be xq itself where col >= ci). Returns out.
    The CUDA kernel for CUDA tensors, ``conv3d_int8_requant_reference``
    for CPU tensors."""
    global requant_launches
    if xq.device.type == "cpu":
        return conv3d_int8_requant_reference(xq, ci, wq, padding, scale,
                                             s_out, negative_slope, out, col)
    _check_int8(xq, wq)
    kx, ky, kz, wci, co = wq.shape
    if wci != ci or out.dtype != torch.int8 or out.shape[:4] != xq.shape[:4]:
        raise ValueError(f"weights of {wci} input channels for ci {ci}, an "
                         f"int8 output over x's rows, got {out.dtype} "
                         f"{tuple(out.shape)}")
    if not (xq.is_contiguous() and out.is_contiguous()):
        raise ValueError("the requantizing int8 conv takes contiguous rows: "
                         "its pitch is the last dimension")
    ldx, ldo = xq.shape[-1], out.shape[-1]
    N, X, Y, Z = xq.shape[:4]
    plan = _plan_requant((N, X, Y, Z), ci, co, (kx, ky, kz), _pads(padding),
                         ldx, ldo, col)
    if (out.untyped_storage().data_ptr() == xq.untyped_storage().data_ptr()
            and col < ci):
        raise ValueError(f"output columns from offset {col} overlap the "
                         f"{ci} input channels of the same buffer")
    if packed is None:
        packed = pack_conv_int8(wq)
    _check_packed(packed, wq, plan["cip"])
    s = _scale(scale, co, "scale")
    so = _scale(s_out, co, "s_out")
    card = _on_card(xq, ("packed", packed), ("scale", s), ("s_out", so),
                    ("out", out))
    if xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the int8 conv kernel copies 16-byte aligned rows")
    if card != torch.cuda.current_device():
        with torch.cuda.device(card):
            return conv3d_int8_requant(xq, ci, wq, padding, scale, s_out,
                                       negative_slope, out, col, packed)
    px, py, pz = _pads(padding)
    _rc(_kernel("requant")(
        xq.data_ptr(), ldx, packed.data_ptr(), s.data_ptr(), so.data_ptr(),
        float(negative_slope), out.data_ptr(), ldo, col,
        N, X, Y, Z, ci, plan["cip"], co, kx, ky, kz, px, py, pz,
        torch._C._cuda_getCurrentRawStream(card)),
        "requantizing int8 conv kernel")
    requant_launches += 1
    return out
