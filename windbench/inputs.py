"""What the benchmark makes and hands to both the program and the
reference: the configuration, the weights and the training volumes, all
from the run's seed; the weights and volumes on the device, with a
``torch.Generator`` on it, in a few large calls.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from windbench import payloads
from windbench.reference.model import (
    discriminator_shapes,
    generator_shapes,
)
from windbench.reference.train import TrainSpec, spec_from_config

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``windbench/<kind>/<name>.json``."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def ini_text(conf: dict) -> str:
    """The configuration file's sections as the program's INI text."""
    lines = []
    for section, keys in conf["sections"].items():
        lines.append(f"[{section}]")
        for k, v in keys.items():
            if isinstance(v, bool):
                v = "True" if v else "False"
            v = json.dumps(v) if isinstance(v, list) else v
            lines.append(f"{k} = {v}")
        lines.append("")
    return "\n".join(lines)


def spec(conf: dict) -> TrainSpec:
    return spec_from_config(conf["sections"])


def seeds(seed: int) -> dict:
    """The run's seed split into the independent 31-bit seeds of its
    parts (weights, data, the batch stream, the state's generator, the
    served fields)."""
    words = np.random.SeedSequence(int(seed) % (1 << 63)).generate_state(5)
    return dict(zip(("weights", "data", "stream", "rng", "fields"),
                    (int(w) & 0x7FFFFFFF for w in words)))


def _filled(shapes: dict, gen, device, init_scale: float) -> dict:
    """One normal draw for every weight of ``shapes`` in one call, cut and
    scaled per leaf to std = init_scale * sqrt(2 / fan_in); biases zero,
    batch-norm scales one."""
    weights = [k for k, s in shapes.items() if len(s) > 1]
    total = sum(math.prod(shapes[k]) for k in weights)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) > 1:
            n = math.prod(s)
            std = init_scale * math.sqrt(2.0 / math.prod(s[1:]))
            out[k] = flat[at:at + n].view(s).mul_(std)
            at += n
        elif k.endswith(".scale"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def weights(conf: dict, seed: int, device) -> dict:
    """G's and D's float32 weights and D's running statistics from
    ``seed``, at the configuration's init scales."""
    sp = spec(conf)
    sec = conf["sections"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    G = _filled(generator_shapes(sp.geometry), gen, device,
                float(sec["GENERATOR"]["weight_init_scale"]))
    hr = hr_xy(conf)
    dp, db = discriminator_shapes(sp.geometry, hr)
    D = _filled(dp, gen, device,
                float(sec["DISCRIMINATOR"]["weight_init_scale"]))
    stats = {k: (torch.ones(s, device=device) if k.endswith(".var")
                 else torch.zeros(s, device=device)) for k, s in db.items()}
    return {"G": G, "D": D, "D_stats": stats}


def hr_xy(conf: dict):
    """The HR extent (x, y) of a training sample or a served field."""
    sec = conf["sections"]
    if bool(sec["GAN"]["enable_slicing"]):
        p = int(sec["GAN"]["slice_size"])
        return p, p
    v = conf["volume"]
    return v[0], v[1]


def volumes(conf: dict, seed: int, device) -> dict:
    """The resident training volumes from ``seed`` on the device: full
    (N, X, Y, Zl, 4) = normalised (u, v, w) and the height channel at the
    HR grid, zraw (N, X, Y, Zl, 1) in metres, and the HR patch's
    coordinates x, y. The flow is ``payloads.field``'s, drawn per volume
    with torch on the device."""
    X, Y, Zl = conf["volume"]
    N = int(conf["train_volumes"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    ter = torch.as_tensor(payloads.terrain(X, Y), **f64)
    gx = torch.arange(X, **f64) * payloads.GRID_SPACING
    gy = torch.arange(Y, **f64) * payloads.GRID_SPACING
    xx, yy = torch.meshgrid(gx, gy, indexing="ij")
    sigma = torch.linspace(0.0, 1.0, Zl + 1, **f64)[1:] ** 1.3
    zag = sigma[None, None, :] * (600.0 - 0.4 * ter[:, :, None])
    z = (zag + ter[:, :, None])[None].expand(N, X, Y, Zl)
    u01 = torch.rand((N, 6), generator=gen, **f64)
    amp = (4.0 + 10.0 * u01[:, 0]).view(N, 1, 1)
    a = (900.0 + 1700.0 * u01[:, 1]).view(N, 1, 1)
    ph = (2 * math.pi * u01[:, 2:]).view(N, 4, 1, 1)
    psi_y = (torch.cos(xx / a + ph[:, 0]) * torch.cos(yy / a + ph[:, 1])
             + 0.5 * torch.cos(2.3 * yy / a + ph[:, 2]))
    psi_x = (-torch.sin(xx / a + ph[:, 0]) * torch.sin(yy / a + ph[:, 1])
             + 0.4 * torch.sin(1.7 * xx / a + ph[:, 3]))
    shear = torch.log1p(zag / 2.0) / math.log1p(600.0 / 2.0)
    noise = torch.randn((3, N, X, Y, Zl), generator=gen, **f64)
    u = (amp * psi_y)[..., None] * shear + 0.15 * noise[0]
    v = (-amp * psi_x)[..., None] * shear + 0.15 * noise[1]
    dtx, dty = torch.gradient(ter, spacing=payloads.GRID_SPACING)
    w = (0.15 * (dtx * amp * psi_y - dty * amp * psi_x)[..., None]
         * torch.exp(-zag / 200.0) + 0.05 * noise[2])
    zc = (z - payloads.Z_MIN) / (payloads.Z_MAX - payloads.Z_MIN)
    full = torch.stack([u / payloads.UVW_MAX, v / payloads.UVW_MAX,
                        w / payloads.UVW_MAX, zc], -1).float()
    px, py = hr_xy(conf)
    coords = (torch.arange(max(px, py), dtype=torch.float32, device=device)
              * payloads.GRID_SPACING)
    return {"full": full.contiguous(),
            "zraw": z[..., None].float().contiguous(),
            "x": coords[:px], "y": coords[:py]}
