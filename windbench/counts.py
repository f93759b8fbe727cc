"""The benchmark's own count of operations and bytes, from shapes.

A conv's multiply-adds are its output voxels times kernel volume times
input and output channels; an operation count is twice that. Each input is
read once and each output written once for the byte counts. The peaks are
NVIDIA's data sheet for one H100 SXM (dense, no sparsity).
"""

from __future__ import annotations

import math

from windbench.reference.model import Geometry, discriminator_layout

H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float, flop_rate: float) -> float:
    """The roofline's bound: the larger of operations over the peak rate
    and bytes over the memory bandwidth."""
    return max(flops / flop_rate, nbytes / H100_HBM_BYTES_S)


def trunk_macs(rows: int, g: Geometry) -> int:
    """Multiply-adds of the RRDB trunk on ``rows`` LR voxels: per RDB
    K = num_convs - 1 growth convs (3^3, nf + gc*k -> gc) and the 1^3 LFF
    (nf + gc*K -> nf)."""
    K = g.num_convs - 1
    J = 3 * g.num_rrdb
    return rows * J * (27 * g.gc * sum(g.nf + g.gc * k for k in range(K))
                       + (g.nf + g.gc * K) * g.nf)


def _trunk_weights(g: Geometry) -> int:
    """The trunk's weight and bias elements."""
    K, J = g.num_convs - 1, 3 * g.num_rrdb
    return J * (27 * g.gc * sum(g.nf + g.gc * k for k in range(K))
                + (g.nf + g.gc * K) * g.nf + g.nf)


def trunk_fwd_bytes(rows: int, g: Geometry, residuals: bool) -> int:
    """Bytes of one call of the trunk kernel in bf16: its input and output
    once, its weights once, and in residual mode each RDB's saved state
    and growths."""
    K, J = g.num_convs - 1, 3 * g.num_rrdb
    res = J * rows * (g.nf + g.gc * K) if residuals else 0
    return 2 * (2 * rows * g.nf + _trunk_weights(g) + res)


def trunk_bwd_bytes(rows: int, g: Geometry) -> int:
    """Bytes of one call of the trunk backward kernel in bf16: it reads the
    growths and the output's cotangent, writes d_x, dU and dLFF, and reads
    the transposed weights once."""
    K, J = g.num_convs - 1, 3 * g.num_rrdb
    return 2 * (J * rows * g.gc * K + 2 * rows * g.nf
                + J * rows * (g.gc * K + g.nf) + _trunk_weights(g))


def stencil_bytes(hr_voxels: int) -> int:
    """One launch of the gradient stencil or its adjoint in float32: the
    3-component field, the heights and the 9-component gradient once each
    (52 bytes a voxel)."""
    return hr_voxels * (12 + 4 + 36)


def g_layers(g: Geometry, lr_shape):
    """[(name, output voxels, kernel volume, cin, cout, input needs a
    gradient)] of G's convs for an LR batch (N, x, y, zl); the trunk is
    one entry of its own (kernel volume 0: ``trunk_macs``)."""
    N, x, y, zl = lr_shape
    lr_vox = N * x * y * zl
    s = g.scale
    hr_vox = lr_vox * s * s
    layers = [("feature_conv", lr_vox, 27, g.in_ch, g.nf, False),
              ("trunk", lr_vox, 0, 0, 0, True),
              ("lr_conv", lr_vox, 27, g.nf, g.nf, True)]
    for i in range(int(math.floor(math.log2(s)))):
        layers.append((f"upconv{i}", lr_vox * 4 ** (i + 1), 27, g.nf, g.nf,
                       True))
    k3 = g.hr_kern ** 3
    hf = g.nf + g.terrain
    layers += [("terrain_conv0", hr_vox, 27, 1, g.terrain, False),
               ("terrain_conv1", hr_vox, 27, g.terrain, g.terrain, True),
               ("hr_conv0_x", hr_vox, k3, g.nf, hf, True),
               ("hr_conv0_t", hr_vox, k3, g.terrain, hf, True),
               ("hr_conv1", hr_vox, k3, hf, 3, True)]
    return layers


def _layer_macs(layer, g: Geometry) -> int:
    name, vox, kv, cin, cout, _ = layer
    return trunk_macs(vox, g) if name == "trunk" else vox * kv * cin * cout


def g_forward_flops(g: Geometry, lr_shape) -> float:
    return 2.0 * sum(_layer_macs(lay, g) for lay in g_layers(g, lr_shape))


def g_backward_flops(g: Geometry, lr_shape) -> float:
    """The weight gradients of every conv and the data gradients of every
    conv whose input needs one (not the LR input's nor the heights')."""
    total = 0
    for lay in g_layers(g, lr_shape):
        m = _layer_macs(lay, g)
        total += m * (2 if lay[5] else 1)
    return 2.0 * total


def d_forward_flops(g: Geometry, hr_shape) -> float:
    """D's convs and linear layers on an HR batch (N, X, Y, Zl)."""
    N, X, Y, Zl = hr_shape
    convs, flat = discriminator_layout(g, (X, Y))
    total = 0
    x, y, z = X, Y, Zl
    for _, cin, cout, k, stride, pad, _ in convs:
        pads = (pad,) * 3
        x, y, z = ((n + 2 * p - kk) // st + 1 for n, p, kk, st in
                   zip((x, y, z), pads, k, stride))
        total += N * x * y * z * math.prod(k) * cin * cout
    total += N * (flat * 100 + 100)
    return 2.0 * total


def d_backward_flops(g: Geometry, hr_shape, weights: bool) -> float:
    """D's backward: data gradients of every layer but the first conv's
    input, and with ``weights`` the weight gradients too."""
    fwd = d_forward_flops(g, hr_shape)
    N, X, Y, Zl = hr_shape
    convs, _ = discriminator_layout(g, (X, Y))
    _, cin, cout, k, _, _, _ = convs[0]
    first = 2.0 * N * X * Y * Zl * math.prod(k) * cin * cout
    return (fwd - first) + (fwd if weights else 0.0)


def g_step_flops(g: Geometry, lr_shape, hr_shape, adversarial: bool) -> float:
    """A G step: G forward and backward; with the adversarial term D on
    the real batch (no gradient) and on the fake one (data gradients)."""
    f = g_forward_flops(g, lr_shape) + g_backward_flops(g, lr_shape)
    if adversarial:
        f += 2 * d_forward_flops(g, hr_shape)
        f += d_backward_flops(g, hr_shape, weights=False)
    return f


def d_step_flops(g: Geometry, lr_shape, hr_shape) -> float:
    """A D step: G's no-grad forward, then D forward and backward (weights
    and data) on the real and the fake batch."""
    return (g_forward_flops(g, lr_shape)
            + 2 * (d_forward_flops(g, hr_shape)
                   + d_backward_flops(g, hr_shape, weights=True)))
