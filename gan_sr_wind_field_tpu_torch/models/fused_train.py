"""Trainable generator forward with the RRDB-trunk kernels.

Counterpart of ``gan_sr_wind_field_tpu/models/fused_train.py``
(``make_trainable_trunk`` / ``apply_trainable``). ``TrainableTrunk`` is a
``torch.autograd.Function``:

- forward: the trunk kernel in its residual mode, which saves every RDB's
  input state and growths (J-major streams), so the backward recomputes
  nothing;
- backward: the backward kernel for d_x and the per-RDB cotangents dU (of
  the growth convs' pre-activations) and dLFF (of the LFF outputs), then
  the **dW stage**: per RDB, one weight-gradient conv of the concat
  [state, growths] against all of dU (every growth conv's kernel is a
  slice of it), one matmul of the concat against dLFF, and the LFF bias
  gradient as the sum of dLFF. The JAX package leaves this stage to XLA,
  outside any Pallas kernel; here it is cuDNN and cuBLAS. Each weight
  gradient is computed in the compute dtype and then widened to float32,
  as the JAX package rounds it.

The weights enter the Function packed with differentiable ops
(``pack_trunk_weights(..., detach=False)``), so the packed-layout gradients
it returns flow back to each module's float32 parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn.grad import conv3d_weight

from gan_sr_wind_field_tpu_torch.models.fused_apply import (
    generator_forward,
    kernel_head_fn,
    kernel_trunk_fn,
    trunk_geometry,
)
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    pack_trunk_weights_bwd,
    rrdb_trunk,
    rrdb_trunk_bwd,
)


def _dw_stage(states, growths, dU, dLFF, shape, nf: int, gc: int, K: int):
    """Packed-layout weight gradients (conv, lff, bias) from the saved
    streams, in the streams' dtype."""
    J = states.shape[0]
    N, X, Y, Z = shape
    gcT = gc * K
    conv, lff, bias = [], [], []

    def ncdhw(t):  # (N, R, C) -> (N, C, X, Y, Z) view of channels-last
        return t.view(N, X, Y, Z, -1).permute(0, 4, 1, 2, 3)

    for j in range(J):
        cat = torch.cat([states[j], growths[j]], dim=-1)  # (N, R, nf + gcT)
        # all pairs: growth conv k's kernel is rows k·gc.., columns ..nf+gc·k
        dw = conv3d_weight(ncdhw(cat), (gcT, nf + gcT, 3, 3, 3),
                           ncdhw(dU[j]), padding=1)
        for k in range(K):
            w = dw[k * gc:(k + 1) * gc, :nf + gc * k]  # (gc, cin, 3, 3, 3)
            conv.append(w.permute(2, 3, 4, 1, 0).reshape(-1))
        lff.append(cat.reshape(-1, nf + gcT).t() @ dLFF[j].reshape(-1, nf))
        bias.append(dLFF[j].float().sum((0, 1)).to(dLFF.dtype))
    return torch.cat(conv), torch.stack(lff), torch.stack(bias)


class TrainableTrunk(torch.autograd.Function):
    """The trunk on packed weights (conv, lff, bias) and x (N, X, Y, Zl, nf),
    all in the compute dtype; ``geom`` holds gc, num_convs, rdb_scale,
    rrdb_scale and negative_slope (> 0: the backward recovers the
    LeakyReLU's sign from the saved growths)."""

    @staticmethod
    def forward(ctx, conv, lff, bias, x, geom):
        packed = {"conv": conv, "lff": lff, "bias": bias}
        out, states, growths = rrdb_trunk(packed, x, with_residuals=True,
                                          **geom)
        ctx.save_for_backward(conv, lff, states, growths)
        ctx.geom = geom
        return out

    @staticmethod
    def backward(ctx, d_out):
        conv, lff, states, growths = ctx.saved_tensors
        return (*trunk_vjp(conv, lff, states, growths, d_out, ctx.geom),
                None)


def trunk_vjp(conv, lff, states, growths, d_out, geom):
    """The trunk's backward from the forward's residuals: the backward
    kernel, then the dW stage. Returns the gradients of (conv, lff, bias,
    x) in the packed layout and the compute dtype."""
    nf = lff.shape[-1]
    gc, K = geom["gc"], geom["num_convs"] - 1
    packed_t = pack_trunk_weights_bwd({"conv": conv, "lff": lff}, nf=nf,
                                      gc=gc, num_convs=geom["num_convs"])
    d_x, dU, dLFF = rrdb_trunk_bwd(
        packed_t, growths, d_out.to(conv.dtype).contiguous(), **geom)
    del packed_t
    d_conv, d_lff, d_bias = _dw_stage(states, growths, dU, dLFF,
                                      tuple(d_out.shape[:4]), nf, gc, K)
    return d_conv, d_lff, d_bias, d_x


def trainable_trunk_fn(G):
    """The trunk of G as a differentiable function of its input and of the
    RRDB modules' parameters. Where no gradient is needed (validation
    under ``torch.no_grad``) it is one launch of the trunk kernel without
    residuals: the same output, no saved streams."""
    no_grad_fn = kernel_trunk_fn(G)

    def trunk_fn(x):
        if not torch.is_grad_enabled():
            return no_grad_fn(x)
        packed = pack_trunk_weights(G.rrdbs, G.dtype, x.device, detach=False)
        return TrainableTrunk.apply(packed["conv"], packed["lff"],
                                    packed["bias"], x.contiguous(),
                                    trunk_geometry(G))

    return trunk_fn


def apply_trainable(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                    train: bool = True,
                    dropout_mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    head: bool = False):
    """Differentiable generator forward with the trunk kernels (and with
    ``head`` the HR-head kernel): gradients flow into G's parameters (the
    trunk's through ``TrainableTrunk``, the head's through ``HRHead``, the
    rest through autograd) and match those of the module path."""
    return generator_forward(G, lr, z_terrain, trainable_trunk_fn(G),
                             train=train, dropout_mask=dropout_mask,
                             generator=generator,
                             head_fn=kernel_head_fn(G) if head else None)
