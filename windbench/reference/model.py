"""The plain reference of the ESRGAN-3D generator and its discriminator.

Written from the model's published description (an RRDB ESRGAN trunk at
the LR grid, nearest x2 upsampling stages, a terrain branch at the HR grid,
a 5^3 HR head split by input channel, and a VGG-style discriminator with
flax-style batch norm), in plain PyTorch on dicts of tensors, channels
last. It imports nothing of the program: the benchmark hands it the same
weights and inputs that it hands the program, and the parameter names are
the program's state_dict keys so that both read one dict.

Every conv and linear layer goes through ``Precision.conv`` /
``Precision.linear``: float32 with TF32 off for the reference, or with
its operands rounded to fp8 (e4m3, per-tensor scale) for the control.
Random draws (channel dropout) come from the generator it is given, in the
order the model description fixes: one keep mask per dropout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Precision:
    """float32 arithmetic (``fp8=False``), or float32 arithmetic on
    operands first rounded to float8 e4m3 with a per-tensor scale that
    maps the tensor's largest magnitude to 448 (``fp8=True``)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if not self.fp8:
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        s = 448.0 / amax
        return (t * s).to(torch.float8_e4m3fn).float() / s

    def conv(self, x, w, pad, stride=1):
        """Channels-last conv: x (N, X, Y, Z, C), w (O, C, kx, ky, kz)."""
        y = F.conv3d(self.q(x).permute(0, 4, 1, 2, 3), self.q(w),
                     padding=pad, stride=stride)
        return y.permute(0, 2, 3, 4, 1)

    def linear(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b.float())


@dataclass(frozen=True)
class Geometry:
    """The sizes of one configuration's models."""
    in_ch: int
    nf: int
    num_rrdb: int
    num_convs: int
    gc: int
    scale: int
    hr_kern: int
    terrain: int
    dropout_g: float
    d_nf: int
    d_kern: int
    dropout_d: float
    z_layers: int
    enable_slicing: bool
    rdb_scale: float = 0.2
    rrdb_scale: float = 0.2
    slope: float = 0.2


def generator_shapes(g: Geometry) -> Dict[str, tuple]:
    """Every G parameter's shape under the program's state_dict key."""
    s = {"feature_conv.weight": (g.nf, g.in_ch, 3, 3, 3)}
    K = g.num_convs - 1
    for i in range(g.num_rrdb):
        for j in range(3):
            p = f"rrdbs.{i}.rdbs.{j}."
            for k in range(K):
                s[p + f"convs.{k}.weight"] = (g.gc, g.nf + g.gc * k, 3, 3, 3)
            s[p + "lff.weight"] = (g.nf, g.nf + g.gc * K, 1, 1, 1)
            s[p + "lff.bias"] = (g.nf,)
    s["lr_conv.weight"] = (g.nf, g.nf, 3, 3, 3)
    for i in range(int(math.floor(math.log2(g.scale)))):
        s[f"upconvs.{i}.weight"] = (g.nf, g.nf, 3, 3, 3)
    s["terrain_conv0.weight"] = (g.terrain, 1, 3, 3, 3)
    s["terrain_conv1.weight"] = (g.terrain, g.terrain, 3, 3, 3)
    hf, k = g.nf + g.terrain, g.hr_kern
    s["hr_conv0_x.weight"] = (hf, g.nf, k, k, k)
    s["hr_conv0_t.weight"] = (hf, g.terrain, k, k, k)
    s["hr_conv1.weight"] = (3, hf, k, k, k)
    s["hr_conv1.bias"] = (3,)
    return s


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def discriminator_layout(g: Geometry, hr_xy):
    """[(prefix, cin, cout, kernel, stride, padding, batch norm)] of D's
    convs and the flattened feature count that fc0 reads."""
    nf = g.d_nf
    specs = [(nf, True, g.z_layers > 19), (nf * 2, False, False),
             (nf * 4, False, False), (nf * 8, False, False)]
    if not g.enable_slicing:
        specs.append((nf * 8, False, True))
    X, Y = hr_xy
    Zl = g.z_layers
    convs, cin, k = [], 3, g.d_kern
    for i, (feats, drop_norm, halve_z) in enumerate(specs):
        convs.append((f"blocks.{i}.conv", cin, feats, (k, k, k), (1, 1, 1),
                      (k - 1) // 2, not drop_norm))
        convs.append((f"blocks.{i}.strided_conv", feats, feats, (4, 4, k),
                      (2, 2, 2) if halve_z else (2, 2, 1), 1, True))
        cin = feats
        X, Y = _out(X, 4, 2, 1), _out(Y, 4, 2, 1)
        Zl = _out(Zl, k, 2 if halve_z else 1, 1)
    if g.enable_slicing:
        convs.append(("head_conv0", cin, nf * 8, (k, k, k), (1, 1, 1), 1,
                      True))
        convs.append(("head_conv1", nf * 8, nf * 8, (k, k, k), (1, 1, 2), 1,
                      True))
        cin = nf * 8
        Zl = _out(Zl, k, 2, 1)
    return convs, X * Y * Zl * cin


def discriminator_shapes(g: Geometry, hr_xy):
    """(parameter shapes, running-statistics shapes) of D."""
    convs, flat = discriminator_layout(g, hr_xy)
    p, b = {}, {}
    for name, cin, cout, k, _, _, bn in convs:
        p[name + ".weight"] = (cout, cin, *k)
        if bn:
            p[name + ".bn.scale"] = (cout,)
            p[name + ".bn.bias"] = (cout,)
            b[name + ".bn.mean"] = (cout,)
            b[name + ".bn.var"] = (cout,)
    p["fc0.weight"], p["fc0.bias"] = (100, flat), (100,)
    p["fc1.weight"], p["fc1.bias"] = (1, 100), (1,)
    return p, b


def _lrelu(x, g: Geometry):
    return F.leaky_relu(x, g.slope)


def _nearest_up2_xy(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _keep_mask(n: int, c: int, p: float, gen, device):
    return torch.rand((n, 1, 1, 1, c), generator=gen, device=device) < 1.0 - p


def generator_forward(P: Params, lr, z, g: Geometry, prec: Precision,
                      train: bool = False,
                      gen: Optional[torch.Generator] = None):
    """SR of lr (N, x, y, zl, C) on heights z (N, X, Y, zl, 1): float32
    (N, X, Y, zl, 3). With ``train`` whole channels after lrelu(hr_conv0)
    are dropped with probability ``g.dropout_g``, drawn from ``gen``."""
    c = prec.conv
    x = c(lr, P["feature_conv.weight"], 1)
    trunk = x
    K = g.num_convs - 1
    for i in range(g.num_rrdb):
        rrdb_in = trunk
        out = trunk
        for j in range(3):
            p = f"rrdbs.{i}.rdbs.{j}."
            feats = out
            for k in range(K):
                feats = torch.cat([feats, _lrelu(
                    c(feats, P[p + f"convs.{k}.weight"], 1), g)], dim=-1)
            lff = c(feats, P[p + "lff.weight"], 0) + P[p + "lff.bias"]
            out = lff * g.rdb_scale + out
        trunk = out * g.rrdb_scale + rrdb_in
    x = x + c(trunk, P["lr_conv.weight"], 1)
    for i in range(int(math.floor(math.log2(g.scale)))):
        x = _lrelu(c(_nearest_up2_xy(x), P[f"upconvs.{i}.weight"], 1), g)
    t = _lrelu(c(z, P["terrain_conv0.weight"], 1), g)
    t = c(t, P["terrain_conv1.weight"], 1)
    hp = (g.hr_kern - 1) // 2
    h = _lrelu(c(x, P["hr_conv0_x.weight"], hp)
               + c(t, P["hr_conv0_t.weight"], hp), g)
    if train and g.dropout_g > 0.0:
        keep = _keep_mask(h.shape[0], h.shape[-1], g.dropout_g, gen,
                          h.device)
        h = torch.where(keep, h / (1.0 - g.dropout_g), torch.zeros_like(h))
    return c(h, P["hr_conv1.weight"], hp) + P["hr_conv1.bias"]


def _batch_norm(y, P, S, name, train: bool, update_stats: bool):
    """flax BatchNorm (momentum 0.9, eps 1e-5, biased variance kept)."""
    if train:
        yd = y.double()
        axes = tuple(range(y.dim() - 1))
        mean = yd.mean(axes)
        var = torch.clamp_min((yd * yd).mean(axes) - mean * mean, 0.0)
        mean, var = mean.float(), var.float()
        if update_stats:
            with torch.no_grad():
                S[name + ".mean"] = 0.9 * S[name + ".mean"] + 0.1 * mean
                S[name + ".var"] = 0.9 * S[name + ".var"] + 0.1 * var
    else:
        mean, var = S[name + ".mean"], S[name + ".var"]
    return ((y - mean) * (torch.rsqrt(var + 1e-5) * P[name + ".scale"])
            + P[name + ".bias"])


def discriminator_forward(P: Params, S: Params, x, g: Geometry,
                          prec: Precision, train: bool,
                          update_stats: bool = False,
                          gen: Optional[torch.Generator] = None):
    """D's logits (N,) for x (N, X, Y, Z, 3). ``S`` holds the running
    statistics (moved in place of its entries with ``update_stats``)."""
    convs, _ = discriminator_layout(g, x.shape[1:3])
    for name, _, _, _, stride, pad, bn in convs:
        x = prec.conv(x, P[name + ".weight"], pad, stride)
        if bn:
            x = _batch_norm(x, P, S, name + ".bn", train, update_stats)
        x = _lrelu(x, g)
    if train and g.dropout_d > 0.0:
        keep = _keep_mask(x.shape[0], x.shape[-1], g.dropout_d, gen,
                          x.device)
        x = torch.where(keep, x / (1.0 - g.dropout_d), torch.zeros_like(x))
    x = x.reshape(x.shape[0], -1)
    x = _lrelu(prec.linear(x, P["fc0.weight"], P["fc0.bias"]), g)
    return prec.linear(x, P["fc1.weight"], P["fc1.bias"]).squeeze(-1)
