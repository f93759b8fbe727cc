"""Calibrated int8 quantization of the RRDB trunk (serving only).

Counterpart of ``gan_sr_wind_field_tpu/ops/quant_trunk.py``, the same
scheme as the int8 head (``ops/quant.py``) carried to the trunk:

- per-part activation scales: every tensor that enters a trunk conv (the
  RDB input and each growth output) has per-channel symmetric scales from
  calibration and is quantized once, where it is made; a dense conv's
  input is the concat of parts already quantized;
- per-output-channel int8 weights with the parts' scales folded into the
  kernel's c_in axis;
- int8 × int8 → int32 convs (the port's CUDA kernels): the growth convs
  3×3×3 dequantize, apply LeakyReLU and requantize in their epilogue
  (``conv3d_int8_requant``, into the step's int8 concat buffer), the LFF
  1×1×1 dequantizes with its bias (``conv3d_int8``); the residual adds
  and the 0.2 scalings stay float, cast to the compute dtype where JAX
  casts.

The trunk math mirrored is the port's RDB/RRDB modules
(``models/blocks.py``). Parameters are a port ``Generator3D`` state_dict
(``rrdbs.{i}.rdbs.{j}.convs.{k}.weight`` ...); the quantized tensors are
stacked over the J = 3·num_rrdb RDB steps (step j = RRDB j // 3, RDB
j % 3) in the flax layout, as the JAX package stacks them, beside the
kernel's packed forms.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from gan_sr_wind_field_tpu_torch.ops.conv_int8 import (
    conv3d_int8,
    conv3d_int8_requant,
    pack_conv_int8,
)
from gan_sr_wind_field_tpu_torch.ops.quant import (
    fold_quantize_kernel,
    quantize_act,
    scales_from_amax,
)


@dataclasses.dataclass(frozen=True)
class QuantizedTrunk:
    """Calibrated int8 trunk weights and scales, stacked over the J RDB
    steps; ``packed``/``packed_lff`` are ``wq``/``wq_lff`` in
    ``pack_conv_int8``'s layout (stacked the same way)."""

    s_x: torch.Tensor                  # (J, nf) scales of the RDB input
    s_c: torch.Tensor                  # (J, K, gc) scales per growth out
    wq: Tuple[torch.Tensor, ...]       # k: (J, 3, 3, 3, nf+gc*k, gc) int8
    sw: Tuple[torch.Tensor, ...]       # k: (J, gc) dequant scales
    wq_lff: torch.Tensor               # (J, lk, lk, lk, nf+gc*K, nf) int8
    sw_lff: torch.Tensor               # (J, nf)
    b_lff: torch.Tensor                # (J, nf) float32
    packed: Tuple[torch.Tensor, ...] = ()
    packed_lff: torch.Tensor = None
    num_rrdb: int = 0
    num_convs: int = 5
    lff_kern: int = 1
    rdb_scale: float = 0.2
    rrdb_scale: float = 0.2
    negative_slope: float = 0.2


def _steps(num_rrdb: int):
    """The key prefixes of the RDB steps in trunk order."""
    for i in range(num_rrdb):
        for j in range(3):
            yield f"rrdbs.{i}.rdbs.{j}."


def _conv(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """float conv of channels-last x with a torch (O, I, k, k, k) weight."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=pad)
    return y.permute(0, 2, 3, 4, 1)


def _flax(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 4, 1, 0)


def _amax(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(dim=tuple(range(v.dim() - 1)))


def trunk_reference_amax(params, x: torch.Tensor, *, num_rrdb: int,
                         num_convs: int, lff_kern: int, rdb_scale: float,
                         rrdb_scale: float, negative_slope: float):
    """Float32 trunk forward with plain convs that also returns the
    calibration amaxes: ``(y, amax_x (J, nf), amax_c (J, K, gc))``, the
    per-channel abs-max of every tensor the int8 path quantizes."""
    K = num_convs - 1
    lp = (lff_kern - 1) // 2
    out = x.to(torch.float32)
    ax_steps, ac_steps = [], []
    steps = list(_steps(num_rrdb))
    si = 0
    for _ in range(num_rrdb):
        rr_in = out
        for _ in range(3):
            p = steps[si]
            si += 1
            feats = out
            ax_steps.append(_amax(out))
            ac_k = []
            for k in range(K):
                w = params[f"{p}convs.{k}.weight"].to(torch.float32)
                c = F.leaky_relu(_conv(feats, w, 1), negative_slope)
                ac_k.append(_amax(c))
                feats = torch.cat([feats, c], dim=-1)
            ac_steps.append(torch.stack(ac_k))
            wl = params[f"{p}lff.weight"].to(torch.float32)
            bl = params[f"{p}lff.bias"].to(torch.float32)
            res = _conv(feats, wl, lp) + bl
            out = res * rdb_scale + out
        out = out * rrdb_scale + rr_in
    return out, torch.stack(ax_steps), torch.stack(ac_steps)


def quantize_trunk(params, amax_x, amax_c, *, num_rrdb: int, num_convs: int,
                   lff_kern: int, rdb_scale: float, rrdb_scale: float,
                   negative_slope: float) -> QuantizedTrunk:
    """Fold the calibrated activation scales into int8 trunk weights;
    ``amax_x``/``amax_c`` come from ``trunk_reference_amax``, max-folded
    over the calibration set on the host. The tensors land on the
    parameters' device."""
    K = num_convs - 1
    dev = params[next(iter(_steps(num_rrdb))) + "lff.bias"].device
    s_x = scales_from_amax(amax_x).to(dev)    # (J, nf)
    s_c = scales_from_amax(amax_c).to(dev)    # (J, K, gc)
    wq_k = [[] for _ in range(K)]
    sw_k = [[] for _ in range(K)]
    wql, swl, bls = [], [], []
    for j, p in enumerate(_steps(num_rrdb)):
        part_scales = [s_x[j]] + [s_c[j, k] for k in range(K)]
        for k in range(K):
            w = _flax(params[f"{p}convs.{k}.weight"])
            wq, sw = fold_quantize_kernel(w, torch.cat(part_scales[:k + 1]))
            wq_k[k].append(wq)
            sw_k[k].append(sw)
        wq, sw = fold_quantize_kernel(_flax(params[f"{p}lff.weight"]),
                                      torch.cat(part_scales))
        wql.append(wq)
        swl.append(sw)
        bls.append(params[f"{p}lff.bias"].to(torch.float32))
    wq = tuple(torch.stack(w) for w in wq_k)
    wq_lff = torch.stack(wql)
    return QuantizedTrunk(
        s_x=s_x, s_c=s_c, wq=wq, sw=tuple(torch.stack(s) for s in sw_k),
        wq_lff=wq_lff, sw_lff=torch.stack(swl), b_lff=torch.stack(bls),
        packed=tuple(torch.stack([pack_conv_int8(w) for w in t])
                     for t in wq),
        packed_lff=torch.stack([pack_conv_int8(w) for w in wq_lff]),
        num_rrdb=int(num_rrdb), num_convs=int(num_convs),
        lff_kern=int(lff_kern), rdb_scale=float(rdb_scale),
        rrdb_scale=float(rrdb_scale), negative_slope=float(negative_slope))


def trunk_int8_apply(qt: QuantizedTrunk, x: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """int8 trunk forward: ``trunk_reference_amax``'s forward up to the
    int8 rounding of activations and weights; num_convs · J launches of
    the int8 conv kernels. Per RDB step one int8 buffer of nf + K·gc
    channels holds the concat: the step's input quantized into its first
    nf, each growth conv (``conv3d_int8_requant``) reading the channels
    before its own and writing its gc requantized channels after them,
    and the LFF (``conv3d_int8``) reading it whole."""
    K = qt.num_convs - 1
    lp = (qt.lff_kern - 1) // 2
    cdt = out_dtype
    # JAX's weak typing: a python scale times a cdt array is a cdt scale
    rrdb_scale = torch.tensor(qt.rrdb_scale, dtype=cdt, device=x.device)
    out = x.to(cdt)
    nf = out.shape[-1]
    gc = qt.s_c.shape[-1]
    j = 0
    for _ in range(qt.num_rrdb):
        rr_in = out
        for _ in range(3):
            buf = torch.empty((*out.shape[:-1], nf + K * gc),
                              dtype=torch.int8, device=x.device)
            buf[..., :nf] = quantize_act(out, qt.s_x[j])
            for k in range(K):
                ci = nf + k * gc
                conv3d_int8_requant(buf, ci, qt.wq[k][j], 1, qt.sw[k][j],
                                    qt.s_c[j, k], qt.negative_slope, buf,
                                    ci, packed=qt.packed[k][j])
            res = conv3d_int8(buf, qt.wq_lff[j], lp, qt.sw_lff[j],
                              bias=qt.b_lff[j], packed=qt.packed_lff[j])
            out = (res * qt.rdb_scale).to(cdt) + out
            j += 1
        out = (out * rrdb_scale + rr_in).to(cdt)
    return out
