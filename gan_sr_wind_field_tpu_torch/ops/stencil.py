"""The wind-field gradient stencil and its adjoint: CUDA kernel wrappers,
plain PyTorch versions and the differentiable ``WindFieldGradient``.

Counterpart of ``gan_sr_wind_field_tpu/ops/pallas/stencil.py``
(``wind_field_gradient_pallas``, ``_gradient_transpose_pallas`` and the
custom VJP ``wind_field_gradient_fused``). The kernels
(``ops/kernels/csrc/stencil.cu``) work on the channels-last field directly:
uvw (N, X, Y, Zl, 3) and Z (N, X, Y, Zl, 1), float32. ``wind_gradient`` and
``wind_gradient_adjoint`` launch them for CUDA tensors and take the plain
versions, ``physics.wind_field_gradient`` and
``wind_gradient_adjoint_reference``, only for CPU tensors.
``plan_stencil`` gives each kernel's tile, grid and shared memory, and
raises for a volume the tiles do not take.

A launch costs the host little beside the kernel's ~0.02 ms: the ctypes
functions are typed once when the library loads, a contiguous float32
tensor is not copied, the plan is cached by shape, and no device context
is entered when the tensor's card is already the current one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from gan_sr_wind_field_tpu_torch.ops.kernels.tc_plan import TC_SMEM_LIMIT
from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

# kernel launches through `wind_gradient` and `wind_gradient_adjoint`
launches = 0
adjoint_launches = 0


def axis_coeffs(coords: torch.Tensor):
    """(A, B, C) of the 3-term stencil f'_i = A_i f_{i+1} + B_i f_i +
    C_i f_{i-1} along the last axis of ``coords`` (a coordinate vector, or
    per-column heights): the h²-weighted nonuniform central difference
    inside, one-sided first-order at the ends with the out-of-range
    coefficient zero. Float32, the kernels' formula."""
    h = coords.float()
    d = h[..., 1:] - h[..., :-1]
    lo, hi = d[..., :-1], d[..., 1:]
    denom = lo * hi * (lo + hi)
    inv_bot, inv_top = 1.0 / d[..., :1], 1.0 / d[..., -1:]
    zeros = torch.zeros_like(inv_bot)
    A = torch.cat([inv_bot, lo ** 2 / denom, zeros], dim=-1)
    B = torch.cat([-inv_bot, (hi ** 2 - lo ** 2) / denom, inv_top], dim=-1)
    C = torch.cat([zeros, -(hi ** 2) / denom, -inv_top], dim=-1)
    return A, B, C


def _shift0(t: torch.Tensor, axis: int, up: bool) -> torch.Tensor:
    """t_{i+1} (up) or t_{i-1} along ``axis``, zero outside."""
    n = t.shape[axis]
    pad = torch.zeros_like(t.narrow(axis, 0, 1))
    if up:
        return torch.cat([t.narrow(axis, 1, n - 1), pad], dim=axis)
    return torch.cat([pad, t.narrow(axis, 0, n - 1)], dim=axis)


def wind_gradient_adjoint_reference(g9: torch.Tensor, x: torch.Tensor,
                                    y: torch.Tensor,
                                    Z: torch.Tensor) -> torch.Tensor:
    """Plain adjoint of the gradient w.r.t. the field: on each axis
    (Lᵀg)_i = A_{i-1} g_{i-1} + B_i g_i + C_{i+1} g_{i+1}, zero outside.
    g9 (N, X, Y, Zl, 9) → (N, X, Y, Zl, 3), float32."""
    g9 = g9.float()
    gx, gy, gz = g9[..., 0:3], g9[..., 3:6], g9[..., 6:9]
    ax, bx, cx = (v[:, None, None, None] for v in axis_coeffs(x))
    ay, by, cy = (v[:, None, None] for v in axis_coeffs(y))
    az, bz, cz = (v[..., None] for v in axis_coeffs(Z[..., 0]))
    d = _shift0(ax * gx, 1, False) + bx * gx + _shift0(cx * gx, 1, True)
    d = d + (_shift0(ay * gy, 2, False) + by * gy
             + _shift0(cy * gy, 2, True))
    return d + (_shift0(az * gz, 3, False) + bz * gz
                + _shift0(cz * gz, 3, True))


@dataclasses.dataclass(frozen=True)
class StencilTile:
    """The strip of one block of the stencil kernels (``csrc/stencil.cu``,
    ``st::Tile<TX, TY, NT, AHEAD>``): tx consecutive x rows of ty columns
    of one sample, all Zl levels, walked row by row by nt threads with the
    input rows ``ahead`` steps ahead of the row computed."""

    tx: int
    ty: int
    nt: int
    ahead: int

    @property
    def ring(self) -> int:
        """Staged input rows: x - 1, x, x + 1 and those in flight."""
        return self.ahead + 3

    @staticmethod
    def _pitch(n: int) -> int:
        return (n + 6) & ~3  # n floats at any offset in a 16-byte line

    def smem_bytes(self, zl: int, cin: int, cout: int, zc: bool) -> int:
        """Dynamic shared memory: the ring of input rows with their y halo
        and of height rows, two output rows, the x and y coefficient
        triples and, for the adjoint (``zc``), the z triples of two rows."""
        p = self._pitch
        return 4 * (self.ring * (p((self.ty + 2) * zl * cin)
                                 + p(self.ty * zl))
                    + 2 * p(self.ty * zl * cout)
                    + 3 * (self.tx + self.ty)
                    + (6 * self.ty * zl if zc else 0))


# the tiles instantiated in csrc/stencil.cu (GradTile, AdjTile)
GRAD_TILE = StencilTile(8, 32, 128, 1)
ADJ_TILE = StencilTile(16, 32, 320, 1)


def plan_stencil(shape, adjoint: bool = False) -> dict:
    """The plan of the gradient kernel (or, with ``adjoint``, of its
    adjoint) for a field of ``shape`` (N, X, Y, Zl, ...): ``tile``,
    ``grid`` (blocks: N x the strips of a sample) and ``smem`` (dynamic
    shared-memory bytes). Raises ValueError for fewer than 2 points on an
    axis, a volume whose columns do not fit a block's shared memory, or a
    sample too large for the kernels' 32-bit offsets."""
    N, X, Y, Zl = (int(v) for v in shape[:4])
    if min(X, Y, Zl) < 2:
        raise ValueError(f"the stencil needs 2 points per axis, got "
                         f"{(X, Y, Zl)}")
    tile = ADJ_TILE if adjoint else GRAD_TILE
    smem = tile.smem_bytes(Zl, 9 if adjoint else 3, 3 if adjoint else 9,
                           adjoint)
    if smem > TC_SMEM_LIMIT:
        raise ValueError(
            f"the stencil's tile needs {smem} bytes of shared memory at "
            f"Zl={Zl}, more than the {TC_SMEM_LIMIT} a block may have")
    if X * Y * Zl * 9 >= 2 ** 31:
        raise ValueError(f"a sample of {(X, Y, Zl)} voxels is too large "
                         f"for the stencil's 32-bit offsets")
    grid = N * -(-X // tile.tx) * -(-Y // tile.ty)
    return dict(tile=tile, grid=grid, smem=smem)


_plan = functools.lru_cache(maxsize=64)(plan_stencil)
_kernels = {}  # ctypes functions by name, typed once when the library loads


def _kernel(name: str):
    if not _kernels:
        from gan_sr_wind_field_tpu_torch.ops.kernels.build import (
            load_library,
        )

        lib = load_library("stencil")
        for n in ("windsr_wind_gradient", "windsr_wind_gradient_adjoint"):
            fn = getattr(lib, n)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            _kernels[n] = fn
    return _kernels[name]


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _launch(name: str, src: torch.Tensor, x, y, Z, out_ch: int):
    if not src.is_cuda:
        raise ValueError(f"no stencil kernel for device {src.device}")
    N, X, Y, Zl, _ = src.shape
    if Z.shape != (N, X, Y, Zl, 1) or x.shape != (X,) or y.shape != (Y,):
        raise ValueError(f"Z {tuple(Z.shape)}, x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)} do not match {tuple(src.shape)}")
    card = src.get_device()
    for t in (Z, x, y):
        if t.get_device() != card:
            raise ValueError(f"stencil inputs on {t.device} and "
                             f"{src.device}")
    _plan((N, X, Y, Zl), out_ch == 3)
    fn = _kernel(name)
    src, hz, x, y = _f32(src), _f32(Z), _f32(x), _f32(y)
    if card != torch.cuda.current_device():
        with torch.cuda.device(card):
            return _launch(name, src, x, y, Z, out_ch)
    out = src.new_empty((N, X, Y, Zl, out_ch))
    # the current stream's handle, without building a Stream object
    rc = fn(src.data_ptr(), hz.data_ptr(), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), N, X, Y, Zl,
            torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def wind_gradient(uvw: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  Z: torch.Tensor) -> torch.Tensor:
    """The 9-channel gradient of uvw (N, X, Y, Zl, 3) on the grid of x
    (X,), y (Y,) and heights Z (N, X, Y, Zl, 1), float32 (N, X, Y, Zl, 9):
    the kernel for CUDA tensors, ``physics.wind_field_gradient`` for CPU
    tensors."""
    global launches
    if uvw.device.type == "cpu":
        return wind_field_gradient(uvw, x, y, Z)
    if uvw.dim() != 5 or uvw.shape[-1] != 3:
        raise ValueError(f"uvw must be (N, X, Y, Zl, 3), got "
                         f"{tuple(uvw.shape)}")
    out = _launch("windsr_wind_gradient", uvw, x, y, Z, 9)
    launches += 1
    return out


def wind_gradient_adjoint(g9: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``wind_gradient`` w.r.t. the field: (N, X, Y, Zl, 9)
    → (N, X, Y, Zl, 3), float32; the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global adjoint_launches
    if g9.device.type == "cpu":
        return wind_gradient_adjoint_reference(g9, x, y, Z)
    if g9.dim() != 5 or g9.shape[-1] != 9:
        raise ValueError(f"g9 must be (N, X, Y, Zl, 9), got "
                         f"{tuple(g9.shape)}")
    out = _launch("windsr_wind_gradient_adjoint", g9, x, y, Z, 3)
    adjoint_launches += 1
    return out


class WindFieldGradient(torch.autograd.Function):
    """Differentiable gradient stencil: the forward kernel, and the adjoint
    kernel as its backward. The grid (x, y, Z) is data, never trained:
    its gradients are None."""

    @staticmethod
    def forward(ctx, uvw, x, y, Z):
        ctx.save_for_backward(x, y, Z)
        return wind_gradient(uvw.detach(), x, y, Z)

    @staticmethod
    def backward(ctx, g9):
        x, y, Z = ctx.saved_tensors
        d = wind_gradient_adjoint(g9.contiguous(), x, y, Z)
        return d, None, None, None
