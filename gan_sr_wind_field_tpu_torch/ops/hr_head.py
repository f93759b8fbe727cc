"""The generator's HR head conv (hr_conv0): CUDA kernel wrapper, plain
PyTorch version, weight packing and the differentiable ``HRHead``.

Counterpart of ``gan_sr_wind_field_tpu/ops/pallas/hr_head.py``
(``hr_head_main`` and the custom VJP ``hr_head``). For the upsampled
features x (N, X, Y, Zl, nf) and the terrain features t (N, X, Y, Zl, tc),
channels-last and in the compute dtype, the head is

    h = dm ⊙ lrelu(conv_k(x; Wx) + conv_k(t; Wt))

with one float32 sum over both convs and all k³ taps, LeakyReLU in
float32, the per-(sample, channel) dropout scale dm (N, C) in the compute
dtype, and one rounding of the product to the compute dtype. The kernel
(``ops/kernels/csrc/hr_head.cu``; bf16 on the tensor cores through the
tile of ``csrc/head_mma.cuh``, which ``plan_head_tc`` plans) computes all
C output channels in one launch; the JAX package splits them into a
128-channel kernel slice and a remainder it rounds separately (a bf16
rounding departure, ROADMAP.md).
``hr_head_conv`` launches it for CUDA tensors and takes
``hr_head_conv_reference`` only for CPU tensors.

Packed weights (``pack_head_weights``): one (k³, nf + tc, C) tensor in the
compute dtype, taps x-major (the flax DHWIO layout), the input channels of
x first, then those of t.

``HRHead`` is the custom VJP: the kernel forward, and a backward from
library transposed convs (``torch.nn.grad``), as the JAX package takes its
backward from ``jax.linear_transpose`` of XLA convs. It needs
``negative_slope > 0``: the backward recovers the LeakyReLU's side from
the saved output h.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_input, conv3d_weight

from gan_sr_wind_field_tpu_torch.ops.kernels.tc_plan import (
    TC_SLICE,
    TC_SMEM_LIMIT,
    TC_ZERO_BYTES,
)

# kernel launches through `hr_head_conv`; chip runs reset and read it to
# show the main path went through the kernel
launches = 0

_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ------------------------------------------------ tensor-core plan (bf16)
@dataclasses.dataclass(frozen=True)
class HeadTile:
    """The bf16 tile of ``head_mma.cuh`` for kernel size ``ks``: ``bm``
    rows x 144 columns per block over ``warps`` warps (``warps // 4``
    warpgroups issuing wgmma m64n144k16), ``stages`` weight slots. Per
    32-channel slice and dx a window of bm + 2(ks // 2)(Z + 1) rows of
    64 B, in one of two buffers; per (slice, dx, dy) the weights of its ks
    taps, 32 x 144, through the ring."""

    ks: int
    bm = 256
    bn = 144  # the wgmma's N
    warps = 16
    stages = 3

    def smem_bytes(self, Z: int) -> int:
        window = 2 * TC_SLICE * (self.bm + 2 * (self.ks // 2) * (Z + 1))
        weights = 2 * TC_SLICE * self.bn * self.ks
        return TC_ZERO_BYTES + 2 * window + self.stages * weights

    def grid(self, rows: int, cout: int) -> tuple:
        return (math.ceil(rows / self.bm), math.ceil(cout / self.bn))


# the instantiations in hr_head.cu, by kernel size
HEAD_TILES = {5: HeadTile(5), 3: HeadTile(3)}


def plan_head_tc(shape, nf: int, tc: int, C: int, k: int,
                 pointers=()) -> dict:
    """The bf16 head kernel's plan for x of ``shape`` (N, X, Y, Zl, nf):

    - ``vec``: channels per copy (8, 4, 2 or 1, for cp.async of 16, 8 or
      4 bytes, or plain loads), the largest that divides nf, tc, C and the
      element offset of every pointer in ``pointers`` (ints);
    - ``tile``, ``grid`` and ``smem`` (dynamic shared-memory bytes).

    Raises ValueError for a kernel size without a tile, or where the tile
    needs more shared memory than a block may have (a deep volume: the
    windows grow with Zl)."""
    if k not in HEAD_TILES:
        raise ValueError(f"the HR-head kernel takes k = 3 or 5, not {k}")
    N, X, Y, Z = (int(v) for v in shape[:4])
    vec = next(v for v in (8, 4, 2, 1)
               if nf % v == 0 and tc % v == 0 and C % v == 0
               and all(p % (2 * v) == 0 for p in pointers))
    tile = HEAD_TILES[k]
    smem = tile.smem_bytes(Z)
    if smem > TC_SMEM_LIMIT:
        raise ValueError(
            f"the bf16 HR head's tile needs {smem} bytes of shared memory "
            f"at Zl={Z}, more than the {TC_SMEM_LIMIT} a block may have")
    return dict(vec=vec, tile=tile, grid=tile.grid(N * X * Y * Z, C),
                smem=smem)


def pack_head_weights(wx: torch.Tensor, wt: torch.Tensor,
                      dtype: torch.dtype, device=None) -> torch.Tensor:
    """hr_conv0_x's (C, nf, k, k, k) and hr_conv0_t's (C, tc, k, k, k)
    weights as the kernel's (k³, nf + tc, C), detached."""
    w = torch.cat([wx.detach(), wt.detach()], dim=1)
    C, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    return (w.permute(2, 3, 4, 1, 0).reshape(k ** 3, cin, C)
            .to(device=device, dtype=dtype).contiguous())


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


def _ndhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 4, 1)


def _check(packed, x, t, dmask, k: int):
    if x.dim() != 5 or t.dim() != 5 or x.shape[:4] != t.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and t {tuple(t.shape)} must be "
                         f"(N, X, Y, Zl, C) on one grid")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"the head's kernel size must be odd, got {k}")
    nf, tc = x.shape[-1], t.shape[-1]
    if packed.dim() != 3 or tuple(packed.shape[:2]) != (k ** 3, nf + tc):
        raise ValueError(f"packed head weights {tuple(packed.shape)} do not "
                         f"match k={k}, nf={nf}, tc={tc}")
    C = packed.shape[2]
    if dmask is not None and tuple(dmask.shape) != (x.shape[0], C):
        raise ValueError(f"dropout scale {tuple(dmask.shape)} is not "
                         f"{(x.shape[0], C)}")
    for name, v in (("t", t), ("packed", packed), ("dmask", dmask)):
        if v is not None and (v.dtype != x.dtype or v.device != x.device):
            raise ValueError(f"{name} is {v.dtype} on {v.device}; x is "
                             f"{x.dtype} on {x.device}")
    return nf, C


def hr_head_conv_reference(packed, x, t, dmask=None, *, k: int,
                           negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch head with the kernel's rounding: both convs in float32
    on the inputs as they are, LeakyReLU and the scale in float32, one
    rounding to x's dtype. Returns (N, X, Y, Zl, C)."""
    nf, C = _check(packed, x, t, dmask, k)
    w = packed.float().view(k, k, k, -1, C).permute(4, 3, 0, 1, 2)
    hp = (k - 1) // 2
    pre = (F.conv3d(_ncdhw(x.float()), w[:, :nf], padding=hp)
           + F.conv3d(_ncdhw(t.float()), w[:, nf:], padding=hp))
    h = F.leaky_relu(pre, negative_slope)
    if dmask is not None:
        h = h * dmask.float()[:, :, None, None, None]
    return _ndhwc(h).to(x.dtype).contiguous()


def hr_head_conv(packed, x, t, dmask=None, *, k: int,
                 negative_slope: float = 0.2) -> torch.Tensor:
    """The head on x and t with packed weights and an optional dropout
    scale (N, C): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Returns a new (N, X, Y, Zl, C) tensor in x's dtype
    (float32 or bfloat16)."""
    global launches
    if x.device.type == "cpu":
        return hr_head_conv_reference(packed, x, t, dmask, k=k,
                                      negative_slope=negative_slope)
    nf, C = _check(packed, x, t, dmask, k)
    if k not in (3, 5):
        raise ValueError(f"the HR-head kernel takes k = 3 or 5, not {k}")
    if x.device.type != "cuda":
        raise ValueError(f"no HR-head kernel for device {x.device}")
    if x.dtype not in _STORAGE:
        raise ValueError(f"HR-head kernel stores float32 or bfloat16, not "
                         f"{x.dtype}")
    if not all(v.is_contiguous() for v in (x, t, packed, dmask)
               if v is not None):
        raise ValueError("HR-head kernel needs contiguous inputs")
    N, X, Y, Z, _ = x.shape
    if N * X * Y * Z >= 2 ** 31:
        raise ValueError("the head's rows overflow the kernel's 32-bit row "
                         "index")
    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("hr_head"),
                 f"windsr_hr_head_{_STORAGE[x.dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        h = torch.empty(N, X, Y, Z, C, dtype=x.dtype, device=x.device)
        vec = 0  # float32: no plan
        if x.dtype == torch.bfloat16:
            ptrs = [v.data_ptr() for v in (x, t, packed, dmask, h)
                    if v is not None]
            vec = plan_head_tc(x.shape, nf, t.shape[-1], C, k,
                               pointers=ptrs)["vec"]
        rc = fn(x.data_ptr(), t.data_ptr(), packed.data_ptr(),
                None if dmask is None else dmask.data_ptr(), h.data_ptr(),
                N, X, Y, Z, nf, t.shape[-1], C, k, vec, negative_slope,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"HR-head kernel launch failed: CUDA error {rc}")
    launches += 1
    return h


class HRHead(torch.autograd.Function):
    """The head as a function of hr_conv0_x's and hr_conv0_t's weights
    (torch layout, compute dtype), x, t and the dropout scale (N, C) or
    None. Forward: the kernel. Backward: ``hr_head_vjp`` on the saved
    output h."""

    @staticmethod
    def forward(ctx, wx, wt, x, t, dmask, k, negative_slope):
        packed = pack_head_weights(wx, wt, x.dtype, x.device)
        h = hr_head_conv(packed, x, t, dmask, k=k,
                         negative_slope=negative_slope)
        ctx.save_for_backward(wx, wt, x, t, dmask, h)
        ctx.k, ctx.slope = k, negative_slope
        return h

    @staticmethod
    def backward(ctx, dh):
        wx, wt, x, t, dmask, h = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        return (*hr_head_vjp(wx, wt, x, t, dmask, h, dh, k=ctx.k,
                             negative_slope=ctx.slope, need=need),
                None, None, None)


def hr_head_vjp(wx, wt, x, t, dmask, h, dh, *, k: int,
                negative_slope: float, need=(True,) * 4):
    """The head's backward from its saved output h: (dWx, dWt, dx, dt) in
    the compute dtype, None where ``need`` says no. dP = dH · lrelu'(pre)
    · dm, the slope's side read from h (as the JAX ``dpre``), then library
    transposed convs."""
    cdt = x.dtype
    f = torch.where(h >= 0, torch.ones((), device=h.device),
                    torch.full((), negative_slope, device=h.device)).to(cdt)
    dp = dh.to(cdt) * f
    if dmask is not None:
        dp = dp * dmask[:, None, None, None, :]
    dp = _ncdhw(dp)
    hp = (k - 1) // 2
    xs, ts = _ncdhw(x), _ncdhw(t)
    dwx = conv3d_weight(xs, wx.shape, dp, padding=hp) if need[0] else None
    dwt = conv3d_weight(ts, wt.shape, dp, padding=hp) if need[1] else None
    dx = (_ndhwc(conv3d_input(xs.shape, wx, dp, padding=hp))
          if need[2] else None)
    dt = (_ndhwc(conv3d_input(ts.shape, wt, dp, padding=hp))
          if need[3] else None)
    return dwx, dwt, dx, dt


def hr_head(wx, wt, x, t, dmask: Optional[torch.Tensor] = None, *, k: int,
            negative_slope: float,
            packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The head on x and t: ``HRHead`` where a gradient is needed, else one
    launch on ``packed`` (``pack_head_weights(wx, wt, x.dtype)``, packed
    here when not given). Counterpart of the JAX ``hr_head``, with all C
    channels in one tensor."""
    if not negative_slope > 0:
        raise ValueError("hr_head needs negative_slope > 0 (its backward "
                         "recovers the LeakyReLU's side from the output)")
    x, t = x.contiguous(), t.contiguous()
    if dmask is not None:
        dmask = dmask.contiguous()
    if torch.is_grad_enabled():
        return HRHead.apply(wx, wt, x, t, dmask, k, negative_slope)
    if packed is None:
        packed = pack_head_weights(wx, wt, x.dtype, x.device)
    return hr_head_conv(packed, x, t, dmask, k=k,
                        negative_slope=negative_slope)
