"""The plain reference of the training step: batches cut from resident
volumes, per-sample rot90/flip augmentation of the vector field, the
relativistic-average GAN losses with one-sided label smoothing and
annealed instance noise, the physics losses (xy/z gradient and divergence
terms normalised by max(HR, SR/100)), global-norm clipping, Adam (optax's
scale_by_adam: b2 0.999, eps 1e-8) with a multistep schedule, and an EMA
of G with the warm-up decay min(d, (1 + n)/(10 + n)).

It follows the model description's order of random draws from one
generator per step stream, so that, handed the same seeds, it draws what
the program draws: per batch its volume indices and Beta(1/4, 1/4) patch
offsets (Johnk's method, 8 candidates a draw) from a generator seeded with
(stream << 32) + batch; per step, from the state's generator, the
augmentation (k, then the x flips, then the y flips), G's channel dropout,
the real and fake labels, the instance noise of the real then the fake
input, and in a D step D's channel dropout on the real then the fake batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from windbench.reference.model import (
    Geometry,
    Precision,
    discriminator_forward,
    generator_forward,
)
from windbench.reference.physics import div3, div_xy, wind_gradient


@dataclass(frozen=True)
class TrainSpec:
    geometry: Geometry
    batch: int
    patch: int
    cf: int
    niter: float
    lr_g: float
    lr_d: float
    beta1_g: float
    beta1_d: float
    milestones: tuple
    gamma: float
    period: int
    ratio: int
    w_adv: float
    w: Dict[str, float]
    clip: float
    ema_decay: float
    smoothing: bool
    instance_noise: bool


def _b(v) -> bool:
    return v if isinstance(v, bool) else str(v).lower() in ("true", "1")


def spec_from_config(c: dict) -> TrainSpec:
    """The reference's reading of a configuration file's sections."""
    d, gan, gen, dis, tr = (c["DEFAULT"], c["GAN"], c["GENERATOR"],
                            c["DISCRIMINATOR"], c["TRAINING"])
    scale = int(d["scale"])
    in_ch = (int(gen["in_num_ch"]) + int(_b(gan["include_pressure"]))
             + int(_b(gan["include_z_channel"]))
             + int(_b(gan["include_above_ground_channel"])))
    slicing = _b(gan["enable_slicing"])
    g = Geometry(
        in_ch=in_ch, nf=int(gen["num_features"]),
        num_rrdb=int(gen["num_RRDB"]), num_convs=int(gen["num_RDB_convs"]),
        gc=int(gen["RDB_growth_chan"]), scale=scale,
        hr_kern=int(gen["hr_kern_size"]),
        terrain=int(gen["terrain_number_of_features"]),
        dropout_g=float(gen["dropout_probability"]),
        d_nf=int(dis["num_features"]), d_kern=int(dis["feat_kern_size"]),
        dropout_d=float(dis["dropout_probability"]),
        z_layers=int(gan["number_of_z_layers"]), enable_slicing=slicing,
        rdb_scale=float(gen["RDB_res_scaling"]),
        rrdb_scale=float(gen["RRDB_res_scaling"]))
    ms = tr["multistep_lr_steps"]
    return TrainSpec(
        geometry=g, batch=int(c["DATASETTRAIN"]["batch_size"]),
        patch=int(gan["slice_size"]) if slicing else 0, cf=scale,
        niter=float(tr["niter"]),
        lr_g=float(tr["learning_rate_g"]), lr_d=float(tr["learning_rate_d"]),
        beta1_g=float(tr["adam_beta1_g"]), beta1_d=float(tr["adam_beta1_d"]),
        milestones=tuple(int(m) for m in ms) if _b(tr["multistep_lr"])
        else (),
        gamma=float(tr["lr_gamma"]), period=int(tr["d_g_train_period"]),
        ratio=int(tr["d_g_train_ratio"]),
        w_adv=float(tr["adversarial_loss_weight"]),
        w={"pix": float(tr["pixel_loss_weight"]),
           "gxy": float(tr["gradient_xy_loss_weight"]),
           "gz": float(tr["gradient_z_loss_weight"]),
           "div": float(tr["divergence_loss_weight"]),
           "xydiv": float(tr["xy_divergence_loss_weight"])},
        clip=float(gen["max_norm"]) if _b(tr["use_grad_clipping"]) else 0.0,
        ema_decay=float(tr["g_ema_decay"]),
        smoothing=_b(tr["use_one_sided_label_smoothing"]),
        instance_noise=_b(tr["use_instance_noise"]))


# ------------------------------------------------------------ batches
def _beta(n, a, gen, device):
    out = torch.full((n,), float("nan"), dtype=torch.float64, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while True:
        uv = torch.rand((2, n, 8), generator=gen, dtype=torch.float64,
                        device=device) ** (1.0 / a)
        s = uv[0] + uv[1]
        ok = (s <= 1.0) & (s > 0.0)
        first = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
        cand = (uv[0] / s).gather(1, first)[:, 0]
        take = todo & ok.any(dim=1)
        out = torch.where(take, cand, out)
        todo = todo & ~take
        if not bool(todo.any()):
            return out


def batch(full, zraw, stream: int, count: int, spec: TrainSpec):
    """Batch ``count`` of the stream: (LR, HR, Z) cut from the resident
    volumes full (N, X, Y, Zl, C) and zraw (N, X, Y, Zl, 1)."""
    dev = full.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(stream) << 32) + int(count))
    N, X, Y = full.shape[:3]
    B = spec.batch
    idx = torch.randint(0, N, (B,), generator=gen, device=dev)
    if spec.patch:
        p = py = spec.patch
        xs = torch.round(_beta(B, 0.25, gen, dev) * (X - p)).long()
        ys = torch.round(_beta(B, 0.25, gen, dev) * (Y - py)).long()
    else:
        p, py = X, Y
        xs = ys = torch.zeros(B, dtype=torch.long, device=dev)
    gx = xs[:, None] + torch.arange(p, device=dev)[None]
    gy = ys[:, None] + torch.arange(py, device=dev)[None]
    i = idx[:, None, None]
    patch = full[i, gx[:, :, None], gy[:, None, :]]
    return (patch[:, ::spec.cf, ::spec.cf].contiguous(),
            patch[..., :3].contiguous(),
            zraw[i, gx[:, :, None], gy[:, None, :]].contiguous())


def _rot_flip(t, k, fx, fy, vector: bool):
    def per(m):
        return m.view((-1,) + (1,) * (t.dim() - 1))

    out = t
    for kk in (1, 2, 3):
        r = torch.rot90(t, kk, dims=(1, 2))
        if vector:
            u, v = r[..., 0], r[..., 1]
            uv = {1: (-v, u), 2: (-u, -v), 3: (v, -u)}[kk]
            r = torch.cat([torch.stack(uv, -1), r[..., 2:]], -1)
        out = torch.where(per(k == kk), r, out)
    for axis, f in ((1, fx), (2, fy)):
        m = torch.flip(out, dims=(axis,))
        if vector:
            c = axis - 1
            m = torch.cat([m[..., :c], -m[..., c:c + 1], m[..., c + 1:]], -1)
        out = torch.where(per(f), m, out)
    return out


def augment(lr, hr, z, gen):
    n, dev = lr.shape[0], lr.device
    k = torch.randint(0, 4, (n,), generator=gen, device=dev)
    fx = torch.rand(n, generator=gen, device=dev) < 0.5
    fy = torch.rand(n, generator=gen, device=dev) < 0.5
    return (_rot_flip(lr, k, fx, fy, True), _rot_flip(hr, k, fx, fy, True),
            _rot_flip(z, k, fx, fy, False))


# ---------------------------------------------------------- schedules
def is_g_step(spec: TrainSpec, it: int) -> bool:
    return spec.ratio == 0 or (it // spec.period) % (spec.ratio + 1) == 0


def _g_steps(spec: TrainSpec, it: int) -> int:
    if spec.ratio == 0:
        return it
    r1, p = spec.ratio + 1, spec.period
    blk, pos = divmod(it, p)
    return (blk + r1 - 1) // r1 * p + (pos + 1 if blk % r1 == 0 else 0) - 1


def schedule(spec: TrainSpec, it: int) -> dict:
    f32 = np.float32
    k = sum(m <= max(it - (2 * spec.period + 1), 0) for m in spec.milestones)
    real = f32(1.0)
    if spec.smoothing:
        real = f32(0.9) + f32(0.1) * f32(it) / f32(spec.niter)
    n = f32(max(_g_steps(spec, it), 1))
    d_eff = min(f32(spec.ema_decay), (f32(1.0) + n) / (f32(10.0) + n))

    def noise(sigma):
        return math.sqrt(max(sigma * (1.0 - (it - 1.0) / spec.niter), 0.0))

    return {"lr_g": float(f32(spec.lr_g) * f32(spec.gamma) ** f32(k)),
            "lr_d": float(f32(spec.lr_d) * f32(spec.gamma) ** f32(k)),
            "real": float(real), "noise_g": noise(2.0),
            "noise_d": noise(1.0), "ema": float(f32(1.0) - d_eff)}


# ------------------------------------------------------------- losses
def _bce(logits, targets):
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def _labels(n, real, gen, dev):
    r = torch.clamp(real + torch.randn(n, generator=gen, device=dev) * 0.0,
                    0.0, 1.0)
    f = torch.clamp(0.0 + torch.randn(n, generator=gen, device=dev) * 0.0,
                    0.0, 1.0)
    return r, f


def _noisy(x, scale, spec: TrainSpec, gen):
    if not spec.instance_noise:
        return x
    return x + torch.rand(x.shape, generator=gen, device=x.device) * scale


def g_loss(PG, PD, SD, lr, hr, z, xc, yc, spec: TrainSpec, sc: dict,
           prec: Precision, gen):
    g = spec.geometry
    fake = generator_forward(PG, lr, z, g, prec, train=True, gen=gen)
    hr3 = hr[..., :3]
    zero = torch.zeros((), device=lr.device)
    adv = zero
    if spec.w_adv != 0.0 or spec.ratio > 0:
        hl, fl = _labels(hr.shape[0], sc["real"], gen, lr.device)
        real_in = _noisy(hr3, sc["noise_g"], spec, gen)
        fake_in = _noisy(fake, sc["noise_g"], spec, gen)
        with torch.no_grad():
            yr = discriminator_forward(PD, SD, real_in, g, prec, False)
        yf = discriminator_forward(PD, SD, fake_in, g, prec, False)
        adv = (_bce(yf - yr.mean(), hl) + _bce(yr - yf.mean(), fl)) / 2.0
        adv = adv * spec.w_adv
    pix = (hr3 - fake).abs().mean() * spec.w["pix"]
    hg, sg = (wind_gradient(t, xc, yc, z) for t in (hr3, fake))

    def both(f):
        return torch.maximum(torch.amax(f(hg)), torch.amax(f(sg)) / 100.0)

    f_xy = both(lambda t: t[..., :6].abs())
    f_z = both(lambda t: t[..., 6:])
    f_div = both(lambda t: div3(t).abs())
    f_xydiv = both(lambda t: div_xy(t).abs())
    w = spec.w
    physics = (
        ((sg[..., :6] / f_xy - hg[..., :6] / f_xy) ** 2).mean() * w["gxy"]
        + ((sg[..., 6:] / f_z - hg[..., 6:] / f_z) ** 2).mean() * w["gz"]
        + ((div3(hg) / f_div - div3(sg) / f_div) ** 2).mean() * w["div"]
        + ((div_xy(hg) / f_xydiv - div_xy(sg) / f_xydiv) ** 2).mean()
        * w["xydiv"])
    return adv + pix + torch.where(torch.isfinite(physics), physics, zero)


def d_loss(PG, PD, SD, lr, hr, z, spec: TrainSpec, sc: dict,
           prec: Precision, gen):
    g = spec.geometry
    with torch.no_grad():
        fake = generator_forward(PG, lr, z, g, prec, train=False)
    hl, fl = _labels(hr.shape[0], sc["real"], gen, lr.device)
    real_in = _noisy(hr[..., :3], sc["noise_d"], spec, gen)
    fake_in = _noisy(fake, sc["noise_d"], spec, gen)
    yr = discriminator_forward(PD, SD, real_in, g, prec, True, True, gen)
    yf = discriminator_forward(PD, SD, fake_in, g, prec, True, True, gen)
    loss = (_bce(yr - yf.mean(), hl) + _bce(yf - yr.mean(), fl)) / 2.0
    return torch.where(torch.all(hl == 0.9), loss - 0.1985, loss)


# ---------------------------------------------------------- optimizer
class Adam:
    def __init__(self, params: dict, beta1: float, clip: float):
        self.beta1, self.clip = beta1, clip
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def clipped(self, grads: dict) -> dict:
        if not self.clip:
            return grads
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if norm < self.clip:
            return grads
        return {k: (g.double() / norm * self.clip).float()
                for k, g in grads.items()}

    def step(self, params: dict, grads: dict, lr: float) -> None:
        b1 = self.beta1
        self.count += 1
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - 0.999 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
                self.nu[k] = 0.999 * self.nu[k] + (1 - 0.999) * g * g
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8)
                params[k] = params[k] - u * lr


def run_steps(spec: TrainSpec, weights: dict, data: dict, seeds: dict,
              start_it: int, n_steps: int, prec: Precision) -> dict:
    """``n_steps`` iterations after ``start_it`` from ``weights`` (G, D and
    D's statistics, left untouched) on the resident volumes ``data``
    (full, zraw, x, y). ``seeds``: ``stream`` of the batches and ``rng``
    of the state's generator. Returns each step's loss, the clipped first
    gradient of G and of D per leaf, and the parameters after the steps."""
    full, zraw = data["full"], data["zraw"]
    dev = full.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seeds["rng"]))
    PG = {k: v.clone().float() for k, v in weights["G"].items()}
    PD = {k: v.clone().float() for k, v in weights["D"].items()}
    SD = {k: v.clone().float() for k, v in weights["D_stats"].items()}
    ema = {k: v.clone() for k, v in PG.items()}
    opt_g = Adam(PG, spec.beta1_g, spec.clip)
    opt_d = Adam(PD, spec.beta1_d, spec.clip)
    losses: List[float] = []
    first = {}
    for it in range(start_it + 1, start_it + n_steps + 1):
        sc = schedule(spec, it)
        lr, hr, z = batch(full, zraw, seeds["stream"], it - 1, spec)
        lr, hr, z = augment(lr, hr, z, gen)
        if is_g_step(spec, it):
            params = {k: v.detach().requires_grad_() for k, v in PG.items()}
            loss = g_loss(params, PD, SD, lr, hr, z, data["x"], data["y"],
                          spec, sc, prec, gen)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(PG[k]) if g is None else g.detach()
                     for k, g in grads.items()}
            grads = opt_g.clipped(grads)
            first.setdefault("G", grads)
            if torch.isfinite(loss):
                opt_g.step(PG, grads, sc["lr_g"])
            with torch.no_grad():
                for k in ema:
                    ema[k] = ema[k] + (PG[k] - ema[k]) * sc["ema"]
        else:
            params = {k: v.detach().requires_grad_() for k, v in PD.items()}
            loss = d_loss(PG, params, SD, lr, hr, z, spec, sc, prec, gen)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(PD[k]) if g is None else g.detach()
                     for k, g in grads.items()}
            grads = opt_d.clipped(grads)
            first.setdefault("D", grads)
            opt_d.step(PD, grads, sc["lr_d"])
        losses.append(float(loss.detach()))
        del params, grads, loss
    return {"losses": losses, "first": first,
            "after": {"G": PG, "G_ema": ema, "D": PD}}
