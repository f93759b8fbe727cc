"""The RRDB trunk forward: CUDA kernel wrapper, plain PyTorch version and
weight packing.

Counterpart of ``fused_rrdb_trunk`` / ``trunk_fusable`` in
``gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py``. The kernel
(``ops/kernels/csrc/rdb_trunk.cu``) runs the whole trunk, all J = 3·num_rrdb
residual dense blocks, in one call. ``rrdb_trunk`` launches it for CUDA
tensors and takes ``rrdb_trunk_reference`` only for CPU tensors.

Packed weights (``pack_trunk_weights``), all in the storage dtype:
  conv : flat; per RDB j, per growth conv k, the (3, 3, 3, nf + gc·k, gc)
         kernel with taps x-major (the flax DHWIO layout)
  lff  : (J, nf + gc·K, nf) LFF weights, K = num_convs - 1
  bias : (J, nf)            LFF bias
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel launches through `rrdb_trunk` (one per trunk forward); chip runs
# reset it and read it to show the main path went through the kernel
launches = 0

_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def trunk_fusable(num_convs: int, lff_kern_size: int, conv_mode: str) -> bool:
    """Whether the trunk kernel computes this generator geometry. Unlike
    the TPU kernel there is no row cap: nothing has to fit on chip."""
    return conv_mode == "3D" and lff_kern_size == 1 and num_convs >= 2


def pack_trunk_weights(rrdbs, dtype: torch.dtype, device=None) -> dict:
    """Stack the trunk parameters of ``Generator3D.rrdbs`` (a sequence of
    ``RRDB`` modules) into the kernel's layout."""
    conv, lff, bias = [], [], []
    for rrdb in rrdbs:
        for rdb in rrdb.rdbs:
            for blk in rdb.convs:
                # (gc, cin, kx, ky, kz) -> (kx, ky, kz, cin, gc)
                conv.append(blk.weight.detach().permute(2, 3, 4, 1, 0)
                            .reshape(-1))
            w = rdb.lff.weight.detach()
            lff.append(w.reshape(w.shape[0], w.shape[1]).t())
            bias.append(rdb.lff.bias.detach())

    def put(t):
        return t.to(device=device, dtype=dtype).contiguous()

    return {
        "conv": put(torch.cat(conv)),
        "lff": put(torch.stack(lff)),
        "bias": put(torch.stack(bias)),
    }


def _check(packed, x, gc: int, num_convs: int, rdbs_per_rrdb: int):
    if x.dim() != 5:
        raise ValueError(f"x must be (N, X, Y, Zl, nf), got {tuple(x.shape)}")
    nf = x.shape[-1]
    K = num_convs - 1
    if K < 1 or gc < 1:
        raise ValueError(f"need num_convs >= 2 and gc >= 1, got "
                         f"{num_convs}, {gc}")
    lff, bias, conv = packed["lff"], packed["bias"], packed["conv"]
    J = lff.shape[0]
    if J % rdbs_per_rrdb:
        raise ValueError(f"{J} RDBs is not a whole number of RRDBs")
    if tuple(lff.shape) != (J, nf + gc * K, nf) or tuple(bias.shape) != (J, nf):
        raise ValueError(
            f"packed LFF {tuple(lff.shape)} / bias {tuple(bias.shape)} do not "
            f"match nf={nf}, gc={gc}, num_convs={num_convs}"
        )
    n_conv = J * sum(27 * (nf + gc * k) * gc for k in range(K))
    if conv.dim() != 1 or conv.numel() != n_conv:
        raise ValueError(f"packed conv has {conv.numel()} weights, "
                         f"expected {n_conv}")
    for name, t in (("conv", conv), ("lff", lff), ("bias", bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"packed {name} is {t.dtype} on {t.device}; x is {x.dtype} "
                f"on {x.device}"
            )
    return J, nf, K


def _conv_kernels(conv, J: int, nf: int, gc: int, K: int):
    """The flat conv pack as per-RDB lists of torch (gc, cin, 3, 3, 3)."""
    out, off = [], 0
    for _ in range(J):
        ws = []
        for k in range(K):
            cin = nf + gc * k
            n = 27 * cin * gc
            ws.append(conv[off:off + n].view(3, 3, 3, cin, gc)
                      .permute(4, 3, 0, 1, 2))
            off += n
        out.append(ws)
    return out


def rrdb_trunk_reference(packed, x, *, gc: int, num_convs: int,
                         rdb_scale: float = 0.2, rrdb_scale: float = 0.2,
                         rdbs_per_rrdb: int = 3,
                         negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch trunk with the kernel's rounding points: convolutions
    in float32, LeakyReLU in float32 then rounded to x's dtype, the LFF
    rounded before the scaled residual adds, which run in x's dtype."""
    J, nf, K = _check(packed, x, gc, num_convs, rdbs_per_rrdb)
    dt = x.dtype
    s1 = torch.tensor(rdb_scale, dtype=dt, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=dt, device=x.device)
    kernels = _conv_kernels(packed["conv"], J, nf, gc, K)
    state = x.permute(0, 4, 1, 2, 3)  # NCDHW view
    rres = state
    for j in range(J):
        if j % rdbs_per_rrdb == 0:
            rres = state
        feats = state.float()
        for w in kernels[j]:
            y = F.leaky_relu(F.conv3d(feats, w.float(), padding=1),
                             negative_slope)
            feats = torch.cat([feats, y.to(dt).float()], dim=1)
        w_lff = packed["lff"][j].t().float()[:, :, None, None, None]
        lff = F.conv3d(feats, w_lff, bias=packed["bias"][j].float())
        new = state + lff.to(dt) * s1
        if j % rdbs_per_rrdb == rdbs_per_rrdb - 1:
            new = rres + new * s2
        state = new
    return state.permute(0, 2, 3, 4, 1).contiguous()


def rrdb_trunk(packed, x, *, gc: int, num_convs: int, rdb_scale: float = 0.2,
               rrdb_scale: float = 0.2, rdbs_per_rrdb: int = 3,
               negative_slope: float = 0.2) -> torch.Tensor:
    """The trunk on ``x`` (N, X, Y, Zl, nf): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns a new tensor of
    x's shape and dtype (float32 or bfloat16)."""
    global launches
    kw = dict(gc=gc, num_convs=num_convs, rdb_scale=rdb_scale,
              rrdb_scale=rrdb_scale, rdbs_per_rrdb=rdbs_per_rrdb,
              negative_slope=negative_slope)
    if x.device.type == "cpu":
        return rrdb_trunk_reference(packed, x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no trunk kernel for device {x.device}")
    J, nf, K = _check(packed, x, gc, num_convs, rdbs_per_rrdb)
    if x.dtype not in _STORAGE:
        raise ValueError(f"trunk kernel stores float32 or bfloat16, "
                         f"not {x.dtype}")
    tensors = (x, packed["conv"], packed["lff"], packed["bias"])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("trunk kernel needs contiguous x and packed weights")
    N, X, Y, Z, _ = x.shape
    rows = N * X * Y * Z
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows overflow the kernel's 32-bit row index")

    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("rdb_trunk"),
                 f"windsr_rrdb_trunk_{_STORAGE[x.dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        scratch = torch.empty(rows * (3 * nf + gc * K), dtype=x.dtype,
                              device=x.device)
        rc = fn(x.data_ptr(), out.data_ptr(), packed["conv"].data_ptr(),
                packed["lff"].data_ptr(), packed["bias"].data_ptr(),
                scratch.data_ptr(), N, X, Y, Z, nf, gc, num_convs, J,
                rdbs_per_rrdb, rdb_scale, rrdb_scale, negative_slope,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RRDB trunk kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
