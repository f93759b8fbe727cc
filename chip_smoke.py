#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve and train the full-width 4x
generator on one NVIDIA card through the hand-written CUDA kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA source of the port (one nvcc call each, in parallel),
     with each one's seconds and ptxas registers and spills;
  3. each kernel against its plain PyTorch version at full width (16 RRDB
     x 3 RDB, nf=128, gc=32, batch 2, LR 16x16x10, weights at init scale
     1.0, non-zero LFF bias), float32 with TF32 off and bfloat16 against
     the bfloat16 plain version on the same inputs: the trunk forward
     (increment trunk(x) - x, float32 <= 1e-4, bf16 <= 3e-2, and bf16 vs
     the float32 plain version <= 3e-2), its residual mode (out, states,
     growths) and the trunk backward (d_x, dU, dLFF) at the same limits;
     the trainable trunk's weight and input gradients against autograd of
     the plain trunk, float32: its backward on the plain forward's
     residuals <= 1e-4, end to end <= 2e-3; the gradient stencil and its
     adjoint at the training shape (32, 64, 64, 10, 3) with a
     terrain-following Z, <= 1e-5, and the adjoint identity to 1e-5;
  4. serve configs/milestone9k.ini (seeded random weights, bf16) through
     WindFieldServer on 127.0.0.1: 4 single-sample and one 8-sample HTTP
     request plus 6 concurrent MicroBatcher.submit calls; every output
     (64, 64, 10, 3) and finite, and the trunk kernel's launch count rose;
     then one batch against the same model with the plain trunk, <= 3e-2;
  5. train configs/milestone9k.ini as it stands (seeded weights at the
     config's init scales, bf16, batch 32): one G step's gradients through
     the kernels against the same step with the RRDB modules and the plain
     stencil (<= 5e-2 relative L2), and, to split that gap, against the
     same step with autograd through the trunk's plain version;
     then from it = 47 four train_steps (48, 49 G; 50, 51 D) and one
     val_step: finite losses and metrics, G and its EMA move on G steps
     only, D and its batch statistics on D steps only, and each kernel's
     launch count rises by what one step predicts;
  6. CUDA-event times (1 warm-up, 5 repeats): the serving forward at batch
     8 with each layer alone, the trunk kernel, its plain version and a
     bf16 cuDNN chain; at batch 32 the G and D steps with their parts, and
     each training kernel beside its plain version, its bound and, for
     the trunk backward, a bf16 cuDNN/cuBLAS chain. Before they are timed,
     the residual mode and the trunk backward are held against their bf16
     plain versions at batch 32 on the trunk input of a training batch
     (<= 3e-2), with the count of growths on the other side of 0.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

T0 = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "configs", "milestone9k.ini")
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # CUDA-core float32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
TIMEOUT_S = 120.0
CSRC = "gan_sr_wind_field_tpu_torch/ops/kernels/csrc"
TPU = "gan_sr_wind_field_tpu/ops/pallas"
# one step's launches of (trunk, trunk backward, gradient, adjoint)
G_STEP_LAUNCHES = (1, 1, 2, 1)
D_STEP_LAUNCHES = (1, 0, 0, 0)
# limits set from measurements, reasons in PERF.md (section 6): the trainable
# trunk end to end, float32 (5.5e-4 measured, from LeakyReLU sign flips of
# pre-activations within rounding of 0), and one G step's bf16 gradients,
# kernels vs the module path (2.2e-2 measured; 1.0e-2 against autograd of
# the trunk's plain version, the rest the RRDB modules' own rounding)
TRAINABLE_TOL = 2e-3
G_GRAD_TOL = 5e-2


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def rel_l2(a, b):
    import torch

    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double())).item()


def check(name, err, tol):
    log(f"  {name}: rel L2 {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        fail(f"{name} disagrees: {err:.3e} > {tol:.0e}")


def cuda_ms(fn, reps=5):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def counters():
    from gan_sr_wind_field_tpu_torch.ops import rdb_trunk, stencil

    return (rdb_trunk.launches, rdb_trunk.bwd_launches, stencil.launches,
            stencil.adjoint_launches)


def reset_counters():
    from gan_sr_wind_field_tpu_torch.ops import rdb_trunk, stencil

    rdb_trunk.launches = rdb_trunk.bwd_launches = 0
    stencil.launches = stencil.adjoint_launches = 0


def cudnn_trunk(weights, x, per=3, rdb_scale=0.2, rrdb_scale=0.2, slope=0.2):
    """The same trunk as one cuDNN call per conv in bfloat16 (the library
    yardstick for `library_ms`; the port never calls this)."""
    import torch
    import torch.nn.functional as F

    s1 = torch.tensor(rdb_scale, dtype=x.dtype, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=x.dtype, device=x.device)
    state = x.permute(0, 4, 1, 2, 3)
    rres = state
    for j, (convs, w_lff, b_lff) in enumerate(weights):
        if j % per == 0:
            rres = state
        feats = state
        for w in convs:
            y = F.leaky_relu(F.conv3d(feats, w, padding=1), slope)
            feats = torch.cat([feats, y], dim=1)
        new = state + F.conv3d(feats, w_lff, b_lff) * s1
        if j % per == per - 1:
            new = rres + new * s2
        state = new
    return state.permute(0, 2, 3, 4, 1)


def cudnn_trunk_bwd(weights, growths, d_out, per=3, rdb_scale=0.2,
                    rrdb_scale=0.2, slope=0.2):
    """The trunk backward-dx (d_x, dU, dLFF) as bf16 cuDNN transposed convs
    and cuBLAS matmuls (the library yardstick for the backward kernel's
    `library_ms`; the port never calls this)."""
    import torch
    import torch.nn.functional as F

    N, X, Y, Z, nf = d_out.shape
    ds = d_out.reshape(N, -1, nf)
    pend = ds
    dU, dLFF = [], []
    for j in range(len(weights) - 1, -1, -1):
        convs, w_lff, _ = weights[j]
        gc = convs[0].shape[0]
        d_r = ds
        if j % per == per - 1:
            pend, d_r = ds, ds * rrdb_scale
        d_lff = d_r * rdb_scale
        d_cat = d_lff @ w_lff[:, :, 0, 0, 0]
        d_s, dg = d_r + d_cat[..., :nf], d_cat[..., nf:]
        dus = [None] * len(convs)
        for k in range(len(convs) - 1, -1, -1):
            g_k = growths[j][..., k * gc:(k + 1) * gc]
            dg_k = dg[..., k * gc:(k + 1) * gc]
            d_u = torch.where(g_k >= 0, dg_k, dg_k * slope)
            dus[k] = d_u
            back = F.conv_transpose3d(
                d_u.view(N, X, Y, Z, gc).permute(0, 4, 1, 2, 3), convs[k],
                padding=1).permute(0, 2, 3, 4, 1).reshape(N, X * Y * Z, -1)
            d_s = d_s + back[..., :nf]
            if k:
                dg = torch.cat([dg[..., :gc * k] + back[..., nf:],
                                dg[..., gc * k:]], dim=-1)
        if j % per == 0:
            d_s = d_s + pend
        ds = d_s
        dU.append(torch.cat(dus, dim=-1))
        dLFF.append(d_lff)
    return ds, dU, dLFF


def serving_stages(sr, lr, z, geom):
    """(name, ms) of each layer of the serving forward, timed alone on
    the inputs the forward gives it (models/fused_apply.py order)."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import rrdb_trunk
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy

    G = sr.G
    stages = []
    with torch.inference_mode():
        lr = lr.to(G.dtype)
        f = G.feature_conv(lr)
        stages.append(("feature_conv", lambda: G.feature_conv(lr)))
        f = f.contiguous()
        tr = rrdb_trunk(sr.packed, f, **geom)
        stages.append(("trunk kernel", lambda: rrdb_trunk(sr.packed, f,
                                                          **geom)))
        stages.append(("lr_conv", lambda: G.lr_conv(tr)))
        h = f + G.lr_conv(tr)
        for i, up in enumerate(G.upconvs):
            h_in = upsample_nearest_xy(h, 2)
            stages.append((f"upconv{i}", lambda up=up, h_in=h_in: up(h_in)))
            h = up(h_in)
        zt = z.to(G.dtype)
        t = G.terrain_conv1(G.terrain_conv0(zt))
        stages.append(("terrain convs", lambda: G.terrain_conv1(
            G.terrain_conv0(zt))))
        stages.append(("hr_conv0_x", lambda: G.hr_conv0_x(h)))
        stages.append(("hr_conv0_t", lambda: G.hr_conv0_t(t)))
        a = F.leaky_relu(G.hr_conv0_x(h) + G.hr_conv0_t(t), G.negative_slope)
        stages.append(("hr_conv1", lambda: G.hr_conv1(a)))
        return [(name, cuda_ms(fn)) for name, fn in stages]


def sample(rng, n, lr_xy, hr_xy, zl, C):
    """A seeded LR batch (noise) and a cumulative-sum terrain height Z."""
    import numpy as np

    lr = rng.standard_normal((n, lr_xy, lr_xy, zl, C)).astype(np.float32)
    z = np.cumsum(rng.random((n, hr_xy, hr_xy, zl, 1)), axis=3)
    return lr, (z / z.max()).astype(np.float32)


def trunk_macs(rows, J, nf, gc, K):
    return rows * J * (27 * gc * sum(nf + gc * k for k in range(K))
                       + (nf + gc * K) * nf)


def bound(flops, nbytes, flop_rate):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def check_trunk_kernels(rrdbs, x, d_out, geom, nf, gc, nconv, dev):
    """Phase 3, trunk: forward (both modes), backward and the trainable
    trunk against their plain versions. Returns the bf16 max abs errors
    of the forward and the backward."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import (
        TrainableTrunk,
        trunk_vjp,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    p32 = pack_trunk_weights(rrdbs, torch.float32, dev)
    p16 = pack_trunk_weights(rrdbs, torch.bfloat16, dev)
    log("trunk forward, no residuals (increment trunk(x) - x):")
    got32 = rrdb_trunk(p32, x, **geom)
    want32 = rrdb_trunk_reference(p32, x, **geom)
    check("fp32 kernel vs fp32 plain", rel_l2(got32 - x, want32 - x), 1e-4)
    x16 = x.to(torch.bfloat16)
    xf = x16.float()
    got16 = rrdb_trunk(p16, x16, **geom).float()
    check("bf16 kernel vs fp32 plain",
          rel_l2(got16 - xf, rrdb_trunk_reference(p32, xf, **geom) - xf),
          3e-2)
    same16 = rrdb_trunk_reference(p16, x16, **geom).float()
    max_abs_fwd = (got16 - same16).abs().max().item()
    check("bf16 kernel vs bf16 plain", rel_l2(got16 - xf, same16 - xf), 3e-2)
    log(f"  bf16 max abs {max_abs_fwd:.3e} of max |out| "
        f"{same16.abs().max().item():.3e}")
    del got32, want32, got16, same16

    max_abs_bwd = 0.0
    for name, packed, tol in (("fp32", p32, 1e-4), ("bf16", p16, 3e-2)):
        xin = x.to(packed["lff"].dtype)
        log(f"trunk forward, residual mode, {name}:")
        got = rrdb_trunk(packed, xin, with_residuals=True, **geom)
        want = rrdb_trunk_reference(packed, xin, with_residuals=True, **geom)
        check("out increment", rel_l2(got[0].float() - xin.float(),
                                      want[0].float() - xin.float()), tol)
        check("states", rel_l2(got[1].float(), want[1].float()), tol)
        check("growths", rel_l2(got[2].float(), want[2].float()), tol)
        growths = want[2]
        del got, want
        log(f"trunk backward, {name}:")
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        dout = d_out.to(xin.dtype)
        got = rrdb_trunk_bwd(packed_t, growths, dout, **geom)
        want = rrdb_trunk_bwd_reference(packed_t, growths, dout, **geom)
        for label, g, w in zip(("d_x", "dU", "dLFF"), got, want):
            check(label, rel_l2(g.float(), w.float()), tol)
            if name == "bf16":
                max_abs_bwd = max(max_abs_bwd,
                                  (g.float() - w.float()).abs().max().item())
        del got, want, growths

    log("trainable trunk, fp32, gradients vs autograd of the plain trunk:")
    tgt = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)
                      ).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in p32.items()}
        xv = x.clone().requires_grad_()
        if kernel:
            out = TrainableTrunk.apply(leaves["conv"], leaves["lff"],
                                       leaves["bias"], xv, geom)
        else:
            out = rrdb_trunk_reference(leaves, xv, **geom)
        (out * tgt).sum().backward()
        grads.append([leaves["conv"].grad, leaves["lff"].grad,
                      leaves["bias"].grad, xv.grad])
    labels = ("conv weights", "LFF weights", "LFF bias", "input")
    with torch.no_grad():
        # the Function's backward on the plain forward's residuals: the
        # backward kernel and the dW stage against autograd, same masks
        _, states, growths = rrdb_trunk_reference(p32, x, with_residuals=True,
                                                  **geom)
        vjp = trunk_vjp(p32["conv"], p32["lff"], states, growths, tgt, geom)
        for label, g, w in zip(labels, vjp, grads[1]):
            check(f"backward on the plain residuals, {label}", rel_l2(g, w),
                  1e-4)
        # end to end the two forwards differ in the last bit, and a growth
        # pre-activation that close to 0 takes the other LeakyReLU slope
        _, _, g_kernel = rrdb_trunk(p32, x, with_residuals=True, **geom)
        flips = ((g_kernel >= 0) != (growths >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {growths.numel()}")
        del states, growths, g_kernel
    for label, g, w in zip(labels, *grads):
        check(f"end to end, {label}", rel_l2(g, w), TRAINABLE_TOL)
    return max_abs_fwd, max_abs_bwd


def stencil_inputs(dev, n=32, xy=64, zl=10):
    """Training-shape field, cotangent, 150 m grid and a terrain-following
    Z: a smooth terrain plus positive per-column increments."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2001)
    uvw = rng.standard_normal((n, xy, xy, zl, 3)).astype(np.float32)
    g9 = rng.standard_normal((n, xy, xy, zl, 9)).astype(np.float32)
    coords = np.arange(xy, dtype=np.float32) * 150.0
    xx = np.linspace(0, 2 * np.pi, xy)
    terrain = 200.0 * np.add.outer(np.sin(xx), np.cos(0.5 * xx))
    z = (terrain[None, :, :, None, None]
         + np.cumsum(10.0 + 20.0 * rng.random((n, xy, xy, zl, 1)), axis=3))
    return [torch.from_numpy(a).to(dev) for a in
            (uvw, coords, coords, z.astype(np.float32), g9)]


def check_stencil_kernels(dev):
    """Phase 3, stencil: kernels 3 and 4 against their plain versions and
    the adjoint identity. Returns the max abs errors."""
    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

    uvw, x, y, Z, g9 = stencil_inputs(dev)
    log(f"gradient stencil and adjoint at {tuple(uvw.shape)}:")
    got = stencil.wind_gradient(uvw, x, y, Z)
    want = wind_field_gradient(uvw, x, y, Z)
    check("gradient kernel vs plain", rel_l2(got, want), 1e-5)
    err_g = (got - want).abs().max().item()
    adj = stencil.wind_gradient_adjoint(g9, x, y, Z)
    want_a = stencil.wind_gradient_adjoint_reference(g9, x, y, Z)
    check("adjoint kernel vs plain", rel_l2(adj, want_a), 1e-5)
    err_a = (adj - want_a).abs().max().item()
    lhs = (got.double() * g9.double()).sum().item()
    rhs = (uvw.double() * adj.double()).sum().item()
    ident = abs(lhs - rhs) / abs(lhs)
    log(f"  adjoint identity <Lu, g> = {lhs:.6e}, <u, L^T g> = {rhs:.6e}, "
        f"rel {ident:.3e} (tol 1e-05)")
    if not ident <= 1e-5:
        fail(f"adjoint identity off by {ident:.3e}")
    return err_g, err_a


def train_phase(cfg, dev, rng, card):
    """Phase 5: the milestone9k WindFieldGAN at batch 32 on the card.
    Returns what phase 6 times."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
        trunk_geometry,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        rrdb_trunk_reference,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    n = cfg.dataset_train.batch_size
    size, s = cfg.gan_config.slice_size, cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    C = cfg.lr_num_channels
    coords = np.arange(size, dtype=np.float32) * 150.0
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    if not gan.use_fused_trunk:
        fail("milestone9k does not take the trunk kernels in training")
    lr_shape = (n, size // s, size // s, zl, C)
    hr_shape = (n, size, size, zl, 3)
    state = gan.init_state(2001, lr_shape, hr_shape)

    def batch():
        lr, z = sample(rng, n, size // s, size, zl, C)
        hr = 0.1 * rng.standard_normal(hr_shape).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (lr, hr, z)]

    log(f"train: milestone9k WindFieldGAN, batch {n}, LR {lr_shape}, "
        f"HR {hr_shape}, bf16")
    # one G step's gradients, kernels vs the plain trunk and stencil, on the
    # same weights, batch, dropout mask and noise draws
    lr, hr, z = batch()
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.use_fused_trunk = False
    plain_cfg.use_pallas_stencil = False
    plain = WindFieldGAN(plain_cfg, coords, coords, device=dev)
    plain.D = gan.D  # the same D module; its parameters come from the state
    gen = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[1]),
                      generator=gen, device=dev) < 0.9
    res = []
    for g in (gan, plain):
        gen = torch.Generator(device=dev).manual_seed(12)
        res.append(g.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
        torch.cuda.synchronize()
    # the plain path once more with autograd through the trunk's plain
    # version instead of the RRDB modules: it rounds where the kernels do,
    # so it splits the gap into the kernels' part and the module path's
    G_ref = plain.G

    def ref_trunk(x):
        packed = pack_trunk_weights(G_ref.rrdbs, G_ref.dtype, x.device,
                                    detach=False)
        return rrdb_trunk_reference(packed, x.contiguous(),
                                    **trunk_geometry(G_ref))

    def ref_forward(lr, z, train=False, trunk=None, dropout_mask=None,
                    generator=None):
        return generator_forward(G_ref, lr, z, ref_trunk, train=train,
                                 dropout_mask=dropout_mask,
                                 generator=generator)

    G_ref.forward = ref_forward
    gen = torch.Generator(device=dev).manual_seed(12)
    res.append(plain.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
    torch.cuda.synchronize()
    (loss_k, _, grads_k), (loss_p, _, grads_p), (loss_r, _, grads_r) = res
    log(f"  G step total loss: kernels {loss_k.item():.6e}, plain "
        f"{loss_p.item():.6e}, plain trunk version {loss_r.item():.6e}")
    worst = max((rel_l2(a, b), name) for a, b, name in
                zip(grads_k, grads_p, state.params_G))

    def flat(gs):
        return torch.cat([g.flatten() for g in gs])

    err = rel_l2(flat(grads_k), flat(grads_p))
    log(f"  worst single tensor: {worst[1]} rel L2 {worst[0]:.3e}")
    log(f"  G gradients, kernels vs autograd of the trunk's plain version: "
        f"rel L2 {rel_l2(flat(grads_k), flat(grads_r)):.3e}; that vs the "
        f"module path: {rel_l2(flat(grads_r), flat(grads_p)):.3e}")
    check("G gradients, kernels vs plain path (bf16)", err, G_GRAD_TOL)
    del plain, res, grads_k, grads_p, grads_r, G_ref

    state.it = 47
    reset_counters()
    for _ in range(4):
        lr, hr, z = batch()
        it = state.it + 1
        g_step = gan.is_g_step(it)
        snap = {name: {k: v.clone() for k, v in tree.items()} for name, tree
                in (("G", state.params_G), ("EMA", state.params_G_ema),
                    ("D", state.params_D), ("BN", state.batch_stats_D))}
        before = counters()
        t = time.monotonic()
        state, metrics = gan.train_step(state, lr, hr, z)
        torch.cuda.synchronize()
        secs = time.monotonic() - t
        rose = tuple(a - b for a, b in zip(counters(), before))
        kind = "G" if g_step else "D"
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"  it {it} ({kind} step, {secs:.2f} s): "
            + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items()))
            + f"; launches trunk/bwd/gradient/adjoint {rose}")
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"non-finite metric at it {it}")
        want = G_STEP_LAUNCHES if g_step else D_STEP_LAUNCHES
        if rose != want:
            fail(f"{kind} step launched {rose}, expected {want}")
        for name, tree in (("G", state.params_G), ("EMA", state.params_G_ema),
                           ("D", state.params_D), ("BN", state.batch_stats_D)):
            moved = any(not torch.equal(v, snap[name][k])
                        for k, v in tree.items())
            should = g_step == (name in ("G", "EMA"))
            if moved != should:
                fail(f"{name} {'moved' if moved else 'stood still'} on the "
                     f"{kind} step at it {it}")
    lr, hr, z = batch()
    metrics, _ = gan.val_step(state, lr, hr, z)
    vals = {k: float(v) for k, v in metrics.items()}
    log("  val: " + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items())))
    if not all(math.isfinite(v) for v in vals.values()):
        fail("non-finite validation metric")
    total = counters()
    log(f"  train path launches (4 steps + val) trunk/bwd/gradient/adjoint "
        f"{total} ({card})")
    return gan, state, batch, total


def time_training(gan, state, batch, geom, nf, gc, nconv, dev, card):
    """Phase 6, training: the trunk kernels against their plain versions
    at batch 32, then G and D steps with their parts, and each training
    kernel beside its plain version, bound and library chain."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import _dw_stage
    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    lr, hr, z = batch()

    def step(it):
        def fn():
            state.it = it - 1
            gan.train_step(state, lr, hr, z)
        return fn

    g_ms = cuda_ms(step(48))
    d_ms = cuda_ms(step(50))
    gen_ms = cuda_ms(lambda: gan.generate(state, lr, z))

    # the trunk kernels at the training batch, on the state's weights
    G = gan.G
    G.load_state_dict(state.params_G)
    with torch.no_grad():
        packed = pack_trunk_weights(G.rrdbs, torch.bfloat16, dev)
        lib_w = [([c.weight.to(torch.bfloat16) for c in rdb.convs],
                  rdb.lff.weight.to(torch.bfloat16),
                  rdb.lff.bias.to(torch.bfloat16))
                 for r in G.rrdbs for rdb in r.rdbs]
        # the trunk's input in a G step on this batch
        x = G.feature_conv(lr.to(G.dtype)).contiguous()
    n = lr.shape[0]
    gen = torch.Generator().manual_seed(3)
    d_out = torch.randn(x.shape, generator=gen).to(dev, torch.bfloat16)
    kw = dict(geom)
    with torch.no_grad():
        log(f"trunk kernels at batch {n}, trunk input of a training batch, "
            f"bf16 vs bf16 plain:")
        got = rrdb_trunk(packed, x, with_residuals=True, **kw)
        want = rrdb_trunk_reference(packed, x, with_residuals=True, **kw)
        xf = x.float()
        check("residual mode, out increment",
              rel_l2(got[0].float() - xf, want[0].float() - xf), 3e-2)
        check("residual mode, states",
              rel_l2(got[1].float(), want[1].float()), 3e-2)
        check("residual mode, growths",
              rel_l2(got[2].float(), want[2].float()), 3e-2)
        # a growth on the other side of 0 takes the other LeakyReLU slope
        # in the backward: what sets the G step's bf16 gradient gap
        flips = ((got[2] >= 0) != (want[2] >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {want[2].numel()} ({flips / want[2].numel():.3e})")
        _, states, growths = got
        del got, want
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        got = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **kw)
        for label, a, b in zip(("d_x", "dU", "dLFF"), got, want):
            check(f"backward, {label}", rel_l2(a.float(), b.float()), 3e-2)
        del got, want
        k1r_ms = cuda_ms(lambda: rrdb_trunk(packed, x, with_residuals=True,
                                            **kw))
        k1r_plain_ms = cuda_ms(lambda: rrdb_trunk_reference(
            packed, x, with_residuals=True, **kw))
        k2_ms = cuda_ms(lambda: rrdb_trunk_bwd(packed_t, growths, d_out, **kw))
        k2_plain_ms = cuda_ms(lambda: rrdb_trunk_bwd_reference(
            packed_t, growths, d_out, **kw))
        k2_lib_ms = cuda_ms(lambda: cudnn_trunk_bwd(lib_w, growths, d_out))
        _, dU, dLFF = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        dw_ms = cuda_ms(lambda: _dw_stage(states, growths, dU, dLFF,
                                          tuple(x.shape[:4]), nf, gc,
                                          nconv - 1))
        del states, growths, dU, dLFF
        uvw, cx, cy, Z, g9 = stencil_inputs(dev)
        k3_ms = cuda_ms(lambda: stencil.wind_gradient(uvw, cx, cy, Z))
        k3_plain_ms = cuda_ms(lambda: wind_field_gradient(uvw, cx, cy, Z))
        k4_ms = cuda_ms(lambda: stencil.wind_gradient_adjoint(g9, cx, cy, Z))
        k4_plain_ms = cuda_ms(lambda: stencil.wind_gradient_adjoint_reference(
            g9, cx, cy, Z))

    rows = x.numel() // nf
    J = len(lib_w)
    K = nconv - 1
    flops = 2 * trunk_macs(rows, J, nf, gc, K)
    w_bytes = 2 * sum(t.numel() for t in packed.values())
    res_bytes = 2 * J * rows * (nf + gc * K)
    b1 = bound(flops, 2 * 2 * x.numel() + w_bytes + res_bytes,
               H100_BF16_FLOPS)
    # backward: reads growths and d_out, writes d_x, dU and dLFF, reads
    # the transposed weights once
    b2 = bound(flops, 2 * (J * rows * gc * K + 2 * x.numel()
                           + J * rows * (gc * K + nf)) + w_bytes,
               H100_BF16_FLOPS)
    vox = uvw.numel() // 3
    # per voxel and component: 3 axes x (3 mul + 2 add); z coefficients
    # ~16 operations per voxel; float32 on the CUDA cores
    b3 = bound(vox * (3 * 15 + 16), vox * (12 + 4 + 36), H100_FP32_FLOPS)
    b4 = bound(vox * (3 * 17 + 3 * 16), vox * (36 + 4 + 12), H100_FP32_FLOPS)
    rest_g = g_ms - k1r_ms - k2_ms - dw_ms - 2 * k3_ms - k4_ms
    log(f"G step {g_ms:.3f} ms, D step {d_ms:.3f} ms, no-grad G forward "
        f"{gen_ms:.3f} ms at batch {n} ({card})")
    for label, ms in (("trunk kernel, residual mode", k1r_ms),
                      ("trunk backward kernel", k2_ms),
                      ("dW stage (cuDNN, cuBLAS)", dw_ms),
                      ("gradient kernel x2", 2 * k3_ms),
                      ("adjoint kernel", k4_ms),
                      ("rest: head/tail convs fwd+bwd, D, losses, Adam",
                       rest_g)):
        log(f"  G step part {label:<48} {ms:9.3f} ms "
            f"{100 * ms / g_ms:5.1f} %")
    log(f"  D step part no-grad G forward {gen_ms:9.3f} ms "
        f"{100 * gen_ms / d_ms:5.1f} %, rest (D fwd+bwd twice, Adam) "
        f"{d_ms - gen_ms:9.3f} ms")
    for label, ms, plain_ms, b, lib in (
            ("trunk residual mode", k1r_ms, k1r_plain_ms, b1, None),
            ("trunk backward", k2_ms, k2_plain_ms, b2, k2_lib_ms),
            ("gradient", k3_ms, k3_plain_ms, b3, None),
            ("adjoint", k4_ms, k4_plain_ms, b4, None)):
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.3f} ms'}, bound "
            f"{b[0]:.4f} ms by {b[1]} (ops {b[2]:.4f}, bytes {b[3]:.4f})")
    times = dict(g_ms=g_ms, d_ms=d_ms, k1r=(k1r_ms, k1r_plain_ms, b1),
                 k2=(k2_ms, k2_plain_ms, b2, k2_lib_ms),
                 k3=(k3_ms, k3_plain_ms, b3), k4=(k4_ms, k4_plain_ms, b4))
    if not all(math.isfinite(v) for v in (g_ms, d_ms, gen_ms, k1r_ms, k2_ms,
                                           dw_ms, k3_ms, k4_ms, k2_lib_ms)):
        fail("a timing is not finite")
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, REPO)
    import numpy as np

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.server import serve
    from gan_sr_wind_field_tpu_torch.models.blocks import RRDB
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
    )
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.ops.kernels import build
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        rrdb_trunk,
        rrdb_trunk_reference,
    )

    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    t = time.monotonic()
    for name, (path, secs, report) in build.build().items():
        log(f"built {name}: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total {time.monotonic() - t:.1f} s")

    # ------------------------------------------- 3. kernels vs plain versions
    cfg = load_config(CFG)
    g = cfg.generator
    nf, gc, nconv = g.num_features, g.RDB_growth_chan, g.num_RDB_convs
    geom = dict(gc=gc, num_convs=nconv, rdb_scale=g.RDB_res_scaling,
                rrdb_scale=g.RRDB_res_scaling, negative_slope=0.2)
    lr_xy = cfg.gan_config.slice_size // cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    gen = torch.Generator().manual_seed(2001)
    rrdbs = [RRDB(nf, gc, num_convs=nconv, init_scale=1.0, generator=gen)
             for _ in range(g.num_RRDB)]
    for r in rrdbs:
        for rdb in r.rdbs:  # non-zero LFF bias, so its path is checked
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    d_out = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    max_abs16, max_abs_bwd = check_trunk_kernels(rrdbs, x, d_out, geom, nf,
                                                 gc, nconv, dev)
    err_grad, err_adj = check_stencil_kernels(dev)
    torch.cuda.synchronize()
    del rrdbs, x, d_out

    # ------------------------------------------------------------ 4. serve
    G0 = generator_from_config(cfg, device=dev, seed=2001)
    sr = WindFieldSR(cfg, G0.state_dict(), device=dev)
    del G0
    if sr.packed is None:
        fail("milestone9k geometry does not take the trunk kernel")
    rng = np.random.default_rng(2001)
    hr_xy = lr_xy * cfg.scale
    C = cfg.lr_num_channels

    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    outs = []
    reset_counters()
    srv = serve(sr, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=20.0)
    pool = ThreadPoolExecutor(max_workers=6)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/upscale"
        for n in (None, None, None, None, 8):
            lr, z = sample(rng, 1 if n is None else n, lr_xy, hr_xy, zl, C)
            if n is None:
                lr, z = lr[0], z[0]
            buf = io.BytesIO()
            np.savez(buf, lr=lr, z=z)
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
                if resp.status != 200:
                    fail(f"HTTP {resp.status}")
                out = np.load(io.BytesIO(resp.read()))["sr"]
            outs.extend([out] if n is None else list(out))
        lr, z = sample(rng, 6, lr_xy, hr_xy, zl, C)
        futs = [pool.submit(srv.batcher.submit, lr[i], z[i], TIMEOUT_S)
                for i in range(6)]
        outs.extend(f.result(timeout=TIMEOUT_S + 30) for f in futs)
        stats = srv.batcher.stats_snapshot()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        srv.close()
    serve_launches = counters()[0]
    log(f"served {len(outs)} samples in {stats['batches']} batches "
        f"(max batch {stats['max_batch_seen']}, errors {stats['errors']}); "
        f"trunk kernel launches {serve_launches}")
    for o in outs:
        if o.shape != (hr_xy, hr_xy, zl, 3) or not np.isfinite(o).all():
            fail(f"bad output: shape {o.shape}, "
                 f"finite {bool(np.isfinite(o).all())}")
    if len(outs) != 18 or serve_launches < 1 or stats["errors"]:
        fail(f"{len(outs)} outputs, {serve_launches} kernel launches, "
             f"{stats['errors']} batch errors")

    lr, z = sample(rng, 8, lr_xy, hr_xy, zl, C)
    lr_d, z_d = torch.from_numpy(lr).to(dev), torch.from_numpy(z).to(dev)
    got = torch.from_numpy(sr.upscale(lr, z))
    with torch.inference_mode():
        want = generator_forward(
            sr.G, lr_d, z_d,
            lambda f: rrdb_trunk_reference(sr.packed, f.contiguous(), **geom),
        ).cpu()
    err_srv = rel_l2(got, want)
    log(f"serving output, kernel trunk vs plain trunk: rel L2 {err_srv:.3e} "
        f"(tol 3e-2)")
    if not err_srv <= 3e-2:
        fail(f"served output disagrees with the plain trunk: {err_srv:.3e}")

    # ------------------------------------------------------------ 5. train
    gan, state, batch, train_launches = train_phase(
        copy.deepcopy(cfg), dev, rng, card)

    # ------------------------------------------------------------ 6. times
    xb = torch.randn(8, lr_xy, lr_xy, zl, nf, generator=gen).to(
        dev, torch.bfloat16)
    kw = dict(geom)
    ms = cuda_ms(lambda: rrdb_trunk(sr.packed, xb, **kw))
    plain_ms = cuda_ms(lambda: rrdb_trunk_reference(sr.packed, xb, **kw))
    lib_w = []
    for r in sr.G.rrdbs:
        for rdb in r.rdbs:
            lib_w.append((
                [c.weight.detach().to(torch.bfloat16) for c in rdb.convs],
                rdb.lff.weight.detach().to(torch.bfloat16),
                rdb.lff.bias.detach().to(torch.bfloat16),
            ))
    with torch.inference_mode():
        lib_ms = cuda_ms(lambda: cudnn_trunk(lib_w, xb))
        fwd_ms = cuda_ms(lambda: sr._generate(lr_d, z_d))
    vox = 8 * hr_xy * hr_xy * zl
    log(f"trunk kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN bf16 "
        f"chain {lib_ms:.3f} ms per batch-8 forward ({card})")
    log(f"serving forward {fwd_ms:.3f} ms per batch of 8, "
        f"{vox / (fwd_ms / 1e3):.4e} HR voxels/s ({card})")
    for name, stage_ms in serving_stages(sr, lr_d, z_d, geom):
        log(f"  stage {name:<13} {stage_ms:9.3f} ms "
            f"{100 * stage_ms / fwd_ms:5.1f} % of the forward")
    rows = xb.shape[0] * lr_xy * lr_xy * zl
    J = 3 * g.num_RRDB
    K = nconv - 1
    # input and output once, the bf16 weights once
    nbytes = 2 * (2 * xb.numel()
                  + sum(t.numel() for t in sr.packed.values()))
    b1 = bound(2 * trunk_macs(rows, J, nf, gc, K), nbytes, H100_BF16_FLOPS)
    del lib_w, sr
    log(f"trunk bound at batch 8: {b1[0]:.4f} ms by {b1[1]} (ops "
        f"{b1[2]:.4f} ms, bytes {b1[3]:.4f} ms)")
    tt = time_training(gan, state, batch, geom, nf, gc, nconv, dev, card)
    if not all(math.isfinite(v) for v in (ms, plain_ms, lib_ms, fwd_ms)):
        fail("a timing is not finite")

    def row(name, src, replaces, launches, err, t, lib, **extra):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
                "replaces": f"{TPU}/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": lib,
                **extra}

    tl = train_launches
    table = {"kernels": [
        row("rrdb_trunk", "rdb_trunk.cu", "rdb_trunk.py:178",
            serve_launches + tl[0], max_abs16, (ms, plain_ms, b1), lib_ms,
            launches_serve=serve_launches, launches_train=tl[0],
            residual_ms=tt["k1r"][0], residual_plain_ms=tt["k1r"][1],
            residual_bound_ms=tt["k1r"][2][0]),
        row("rrdb_trunk_bwd", "rdb_trunk_bwd.cu", "rdb_trunk.py:429", tl[1],
            max_abs_bwd, tt["k2"][:3], tt["k2"][3]),
        row("wind_gradient", "stencil.cu", "stencil.py:78", tl[2], err_grad,
            tt["k3"], None),
        row("wind_gradient_adjoint", "stencil.cu", "stencil.py:166", tl[3],
            err_adj, tt["k4"], None),
    ]}
    log(f"total {time.monotonic() - T0:.1f} s")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
