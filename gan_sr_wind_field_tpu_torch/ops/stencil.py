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
"""

from __future__ import annotations

import ctypes

import torch

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


def _launch(name: str, src: torch.Tensor, x, y, Z, out_ch: int):
    if src.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {src.device}")
    N, X, Y, Zl, _ = src.shape
    if min(X, Y, Zl) < 2:
        raise ValueError(f"the stencil needs 2 points per axis, got "
                         f"{(X, Y, Zl)}")
    if tuple(Z.shape) != (N, X, Y, Zl, 1) or x.shape != (X,) or \
            y.shape != (Y,):
        raise ValueError(f"Z {tuple(Z.shape)}, x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)} do not match {tuple(src.shape)}")
    for t in (Z, x, y):
        if t.device != src.device:
            raise ValueError(f"stencil inputs on {t.device} and {src.device}")
    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("stencil"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    src, hz, x, y = (t.float().contiguous() for t in (src, Z, x, y))
    with torch.cuda.device(src.device):
        out = torch.empty(N, X, Y, Zl, out_ch, dtype=torch.float32,
                          device=src.device)
        rc = fn(src.data_ptr(), hz.data_ptr(), x.data_ptr(), y.data_ptr(),
                out.data_ptr(), N, X, Y, Zl,
                torch.cuda.current_stream(src.device).cuda_stream)
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
