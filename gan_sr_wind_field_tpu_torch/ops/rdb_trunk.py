"""The RRDB trunk, forward and backward-dx: CUDA kernel wrappers, plain
PyTorch versions and weight packing.

Counterpart of ``fused_rrdb_trunk``, ``fused_rrdb_trunk_bwd`` and
``trunk_fusable`` in ``gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py``. The
forward kernel (``ops/kernels/csrc/rdb_trunk.cu``) runs the whole trunk, all
J = 3·num_rrdb residual dense blocks, in one call, optionally saving each
RDB's input state and growths; the backward kernel
(``ops/kernels/csrc/rdb_trunk_bwd.cu``) runs back over the RDBs from those
growths. ``rrdb_trunk`` and ``rrdb_trunk_bwd`` launch them for CUDA tensors
and take ``rrdb_trunk_reference`` / ``rrdb_trunk_bwd_reference`` only for
CPU tensors.

Packed weights (``pack_trunk_weights``), all in the storage dtype:
  conv : flat; per RDB j, per growth conv k, the (3, 3, 3, nf + gc·k, gc)
         kernel with taps x-major (the flax DHWIO layout)
  lff  : (J, nf + gc·K, nf) LFF weights, K = num_convs - 1
  bias : (J, nf)            LFF bias
Transposed weights for the backward (``pack_trunk_weights_bwd``):
  conv : flat; per RDB j, per growth conv k, the (27, gc, nf + gc·k) kernel
         with the taps flipped and in/out swapped
  lff  : (J, nf, nf + gc·K)

Residual streams are J-major: states (J, N, R, nf) and growths, dU
(J, N, R, gc·K), dLFF (J, N, R, nf), R = X·Y·Zl rows, as in the JAX kernels.

bfloat16 runs on the tensor cores with the tiles of
``ops/kernels/csrc/trunk_mma.cuh``; ``plan_trunk_tc`` gives their grids,
shared memory and copy width, and raises for what they cannot take.
float32 runs on the CUDA cores and needs no plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from gan_sr_wind_field_tpu_torch.ops.kernels.tc_plan import (
    TC_SLICE,
    TC_SMEM_LIMIT,
    TC_ZERO_BYTES,
)

# kernel launches through `rrdb_trunk` (one per trunk forward, either mode)
# and `rrdb_trunk_bwd`; chip runs reset them and read them to show the main
# path went through the kernels
launches = 0
bwd_launches = 0

_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def trunk_fusable(num_convs: int, lff_kern_size: int, conv_mode: str) -> bool:
    """Whether the trunk kernel computes this generator geometry. Unlike
    the TPU kernel there is no row cap: nothing has to fit on chip."""
    return conv_mode == "3D" and lff_kern_size == 1 and num_convs >= 2


def pack_trunk_weights(rrdbs, dtype: torch.dtype, device=None,
                       detach: bool = True) -> dict:
    """Stack the trunk parameters of ``Generator3D.rrdbs`` (a sequence of
    ``RRDB`` modules) into the kernel's layout. With ``detach=False`` the
    packing is differentiable, so gradients in the packed layout flow back
    to the modules' parameters."""
    conv, lff, bias = [], [], []

    def take(p):
        return p.detach() if detach else p

    for rrdb in rrdbs:
        for rdb in rrdb.rdbs:
            for blk in rdb.convs:
                # (gc, cin, kx, ky, kz) -> (kx, ky, kz, cin, gc)
                conv.append(take(blk.weight).permute(2, 3, 4, 1, 0)
                            .reshape(-1))
            w = take(rdb.lff.weight)
            lff.append(w.reshape(w.shape[0], w.shape[1]).t())
            bias.append(take(rdb.lff.bias))

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
                         rdbs_per_rrdb: int = 3, negative_slope: float = 0.2,
                         with_residuals: bool = False):
    """Plain PyTorch trunk with the kernel's rounding points: convolutions
    in float32, LeakyReLU in float32 then rounded to x's dtype, the LFF
    rounded before the scaled residual adds, which run in x's dtype.
    With ``with_residuals`` it returns ``(out, states, growths)``."""
    J, nf, K = _check(packed, x, gc, num_convs, rdbs_per_rrdb)
    dt = x.dtype
    s1 = torch.tensor(rdb_scale, dtype=dt, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=dt, device=x.device)
    kernels = _conv_kernels(packed["conv"], J, nf, gc, K)
    state = x.permute(0, 4, 1, 2, 3)  # NCDHW view
    rres = state
    states, growths = [], []
    for j in range(J):
        if j % rdbs_per_rrdb == 0:
            rres = state
        feats = state.float()
        for w in kernels[j]:
            y = F.leaky_relu(F.conv3d(feats, w.float(), padding=1),
                             negative_slope)
            feats = torch.cat([feats, y.to(dt).float()], dim=1)
        if with_residuals:
            states.append(state)
            growths.append(feats[:, nf:].to(dt))
        w_lff = packed["lff"][j].t().float()[:, :, None, None, None]
        lff = F.conv3d(feats, w_lff, bias=packed["bias"][j].float())
        new = state + lff.to(dt) * s1
        if j % rdbs_per_rrdb == rdbs_per_rrdb - 1:
            new = rres + new * s2
        state = new
    out = state.permute(0, 2, 3, 4, 1).contiguous()
    if not with_residuals:
        return out

    def stream(ts):  # per-RDB NCDHW -> J-major (J, N, R, C)
        t = torch.stack(ts).permute(0, 1, 3, 4, 5, 2)
        return t.reshape(J, x.shape[0], -1, t.shape[-1]).contiguous()

    return out, stream(states), stream(growths)


# ----------------------------------------------- tensor-core plan (bf16)
@dataclasses.dataclass(frozen=True)
class TcTile:
    """One bf16 tile of ``trunk_mma.cuh``: kernel size ``ks`` (1 or 3),
    ``bm`` rows x ``bn`` columns per block (per column chunk), ``stages``
    ring slots. A stage works on one 32-channel slice and, for a 3x3x3
    conv, one dx: its input window (bm + 2(Z+1) rows; bm rows for 1x1x1)
    and the weights of its taps (9 or 1). A streaming tile passes both
    through the ring; a ``resident`` tile owns every column of its rows,
    keeps all its windows and passes only the weights through the ring."""

    ks: int
    bm: int
    bn: int
    stages: int
    resident: bool = False

    def smem_bytes(self, Z: int, cin: int) -> int:
        window = 2 * TC_SLICE * (self.bm + 2 * (Z + 1) if self.ks == 3
                                 else self.bm)
        weights = 2 * TC_SLICE * self.bn * (9 if self.ks == 3 else 1)
        if not self.resident:
            return TC_ZERO_BYTES + self.stages * (window + weights)
        windows = math.ceil(cin / TC_SLICE) * (3 if self.ks == 3 else 1)
        return TC_ZERO_BYTES + windows * window + self.stages * weights

    def grid(self, rows: int, cout: int) -> tuple:
        return (math.ceil(rows / self.bm),
                1 if self.resident else math.ceil(cout / self.bn))


# the instantiations in rdb_trunk.cu and rdb_trunk_bwd.cu
FWD_GROWTH_TILE = TcTile(3, 256, 32, 3)
FWD_LFF_TILE = TcTile(1, 64, 128, 3)
BWD_GROWTH_TILE = TcTile(3, 256, 32, 3, True)
BWD_LFF_TILE = TcTile(1, 128, 64, 4, True)


def plan_trunk_tc(shape, nf: int, gc: int, num_convs: int,
                  pointers=()) -> dict:
    """The bf16 kernels' plan for an input of ``shape`` (N, X, Y, Zl):

    - ``vec``: channels per copy (8, 4, 2 or 1, for cp.async of 16, 8 or
      4 bytes, or plain loads), the largest that divides nf, gc and the
      element offset of every pointer in ``pointers`` (ints);
    - ``convs``: per conv, its tile, grid (for the widest, where the width
      varies) and shared-memory bytes.

    Raises ValueError where a tile needs more shared memory than a block
    may have (a deep volume: the windows grow with Zl)."""
    N, X, Y, Z = (int(v) for v in shape)
    rows = N * X * Y * Z
    K = num_convs - 1
    vec = next(v for v in (8, 4, 2, 1)
               if nf % v == 0 and gc % v == 0
               and all(p % (2 * v) == 0 for p in pointers))
    convs = {}
    for name, tile, cin, cout in (
            ("fwd_growth", FWD_GROWTH_TILE, nf + gc * (K - 1), gc),
            ("fwd_lff", FWD_LFF_TILE, nf + gc * K, nf),
            ("bwd_growth", BWD_GROWTH_TILE, gc, nf + gc * (K - 1)),
            ("bwd_lff", BWD_LFF_TILE, nf, nf + gc * K)):
        smem = tile.smem_bytes(Z, cin)
        if smem > TC_SMEM_LIMIT:
            raise ValueError(
                f"the bf16 trunk's {name} tile needs {smem} bytes of shared "
                f"memory at Zl={Z}, more than the {TC_SMEM_LIMIT} a block "
                f"may have")
        convs[name] = dict(tile=tile, grid=tile.grid(rows, cout),
                           smem=smem)
    return dict(vec=vec, convs=convs)


def _ctypes_fn(lib: str, name: str, n_ptr: int, n_int: int):
    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return fn


def _check_cuda(x, tensors, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if x.dtype not in _STORAGE:
        raise ValueError(f"{what} kernel stores float32 or bfloat16, "
                         f"not {x.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous inputs")
    rows = x.numel() // x.shape[-1]
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows overflow the kernel's 32-bit row index")
    return rows


def rrdb_trunk(packed, x, *, gc: int, num_convs: int, rdb_scale: float = 0.2,
               rrdb_scale: float = 0.2, rdbs_per_rrdb: int = 3,
               negative_slope: float = 0.2, with_residuals: bool = False):
    """The trunk on ``x`` (N, X, Y, Zl, nf): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns a new tensor of
    x's shape and dtype (float32 or bfloat16); with ``with_residuals``,
    ``(out, states, growths)`` for the backward."""
    global launches
    kw = dict(gc=gc, num_convs=num_convs, rdb_scale=rdb_scale,
              rrdb_scale=rrdb_scale, rdbs_per_rrdb=rdbs_per_rrdb,
              negative_slope=negative_slope, with_residuals=with_residuals)
    if x.device.type == "cpu":
        return rrdb_trunk_reference(packed, x, **kw)
    J, nf, K = _check(packed, x, gc, num_convs, rdbs_per_rrdb)
    rows = _check_cuda(x, (x, packed["conv"], packed["lff"], packed["bias"]),
                       "trunk")
    N, X, Y, Z, _ = x.shape
    fn = _ctypes_fn("rdb_trunk", f"windsr_rrdb_trunk_{_STORAGE[x.dtype]}",
                    8, 10)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        if with_residuals:
            scratch = None
            states = torch.empty(J, N, X * Y * Z, nf, dtype=x.dtype,
                                 device=x.device)
            growths = torch.empty(J, N, X * Y * Z, gc * K, dtype=x.dtype,
                                  device=x.device)
        else:
            scratch = torch.empty(rows * (3 * nf + gc * K), dtype=x.dtype,
                                  device=x.device)
            states = growths = None
        ptr = [None if t is None else t.data_ptr()
               for t in (scratch, states, growths)]
        data = [t.data_ptr() for t in (x, out, packed["conv"],
                                       packed["lff"], packed["bias"])]
        vec = 0  # float32: no plan
        if x.dtype == torch.bfloat16:
            vec = plan_trunk_tc((N, X, Y, Z), nf, gc, num_convs,
                                [p for p in data + ptr if p is not None]
                                )["vec"]
        rc = fn(*data, *ptr,
                N, X, Y, Z, nf, gc, num_convs, J, rdbs_per_rrdb, vec,
                rdb_scale, rrdb_scale, negative_slope,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RRDB trunk kernel launch failed: CUDA error {rc}")
    launches += 1
    return (out, states, growths) if with_residuals else out


# ------------------------------------------------------------- backward
def pack_trunk_weights_bwd(packed, *, nf: int, gc: int,
                           num_convs: int) -> dict:
    """The backward kernel's transposed weights from a forward pack: per
    growth conv the (27, gc, nf + gc·k) kernel with flipped taps (tap t of
    the forward becomes tap 26 - t, its offset negated), and the LFF as
    (J, nf, nf + gc·K)."""
    K = num_convs - 1
    J = packed["lff"].shape[0]
    conv = []
    for ws in _conv_kernels(packed["conv"], J, nf, gc, K):
        for w in ws:  # (gc, cin, 3, 3, 3)
            conv.append(w.flip(2, 3, 4).permute(2, 3, 4, 0, 1).reshape(-1))
    return {"conv": torch.cat(conv).contiguous(),
            "lff": packed["lff"].transpose(1, 2).contiguous()}


def _check_bwd(packed_t, growths, d_out, gc: int, num_convs: int,
               rdbs_per_rrdb: int, negative_slope: float):
    if d_out.dim() != 5:
        raise ValueError(f"d_out must be (N, X, Y, Zl, nf), got "
                         f"{tuple(d_out.shape)}")
    N, X, Y, Z, nf = d_out.shape
    K = num_convs - 1
    lff = packed_t["lff"]
    J = lff.shape[0]
    if K < 1 or J % rdbs_per_rrdb:
        raise ValueError(f"need num_convs >= 2 and whole RRDBs, got "
                         f"num_convs={num_convs}, J={J}")
    if not negative_slope > 0:
        raise ValueError("the trunk backward recovers the LeakyReLU sign "
                         "from the stored growths: needs negative_slope > 0")
    if tuple(lff.shape) != (J, nf, nf + gc * K):
        raise ValueError(f"packed LFF {tuple(lff.shape)} does not match "
                         f"nf={nf}, gc={gc}, num_convs={num_convs}")
    n_conv = J * sum(27 * (nf + gc * k) * gc for k in range(K))
    if packed_t["conv"].numel() != n_conv:
        raise ValueError(f"packed conv has {packed_t['conv'].numel()} "
                         f"weights, expected {n_conv}")
    if tuple(growths.shape) != (J, N, X * Y * Z, gc * K):
        raise ValueError(f"growths {tuple(growths.shape)} do not match "
                         f"{(J, N, X * Y * Z, gc * K)}")
    for name, t in (("conv", packed_t["conv"]), ("lff", lff),
                    ("growths", growths)):
        if t.dtype != d_out.dtype or t.device != d_out.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; d_out is "
                             f"{d_out.dtype} on {d_out.device}")
    return J, nf, K


def rrdb_trunk_bwd_reference(packed_t, growths, d_out, *, gc: int,
                             num_convs: int, rdb_scale: float = 0.2,
                             rrdb_scale: float = 0.2, rdbs_per_rrdb: int = 3,
                             negative_slope: float = 0.2):
    """Plain PyTorch backward-dx with the kernel's rounding points: sums
    in float32; d_r, d_lff, ds and dg in d_out's dtype; each conv's
    contribution rounded before it is added. Returns (d_x, dU, dLFF)."""
    J, nf, K = _check_bwd(packed_t, growths, d_out, gc, num_convs,
                          rdbs_per_rrdb, negative_slope)
    dt = d_out.dtype
    N, X, Y, Z, _ = d_out.shape
    per = rdbs_per_rrdb
    s1 = torch.tensor(rdb_scale, dtype=dt, device=d_out.device)
    s2 = torch.tensor(rrdb_scale, dtype=dt, device=d_out.device)
    slope = torch.tensor(negative_slope, dtype=torch.float32).to(dt)
    kernels, off = [], 0
    for _ in range(J):
        ws = []
        for k in range(K):
            cin = nf + gc * k
            n = 27 * gc * cin
            # (27, gc, cin) -> conv weight (cin, gc, 3, 3, 3)
            ws.append(packed_t["conv"][off:off + n].view(3, 3, 3, gc, cin)
                      .permute(4, 3, 0, 1, 2))
            off += n
        kernels.append(ws)

    def ncdhw(t):  # (N, R, C) -> (N, C, X, Y, Z) view
        return t.view(N, X, Y, Z, -1).permute(0, 4, 1, 2, 3)

    ds = d_out.reshape(N, -1, nf)
    pend = torch.zeros_like(ds)
    dU = torch.empty_like(growths)
    dLFF = torch.empty(J, N, X * Y * Z, nf, dtype=dt, device=d_out.device)
    for j in range(J - 1, -1, -1):
        d_r = ds
        if j % per == per - 1:
            pend = ds
            d_r = ds * s2
        d_lff = d_r * s1
        dLFF[j] = d_lff
        d_catl = d_lff.float() @ packed_t["lff"][j].float()
        d_s = d_r + d_catl[..., :nf].to(dt)
        dg = d_catl[..., nf:].to(dt)
        for k in range(K - 1, -1, -1):
            g_k = growths[j][..., k * gc:(k + 1) * gc].float()
            lmask = torch.where(g_k >= 0, torch.ones_like(g_k),
                                slope.float()).to(dt)
            d_u = dg[..., k * gc:(k + 1) * gc] * lmask
            dU[j][..., k * gc:(k + 1) * gc] = d_u
            back = F.conv3d(ncdhw(d_u).float(), kernels[j][k].float(),
                            padding=1)
            back = back.permute(0, 2, 3, 4, 1).reshape(N, -1, nf + gc * k)
            d_s = d_s + back[..., :nf].to(dt)
            if k:
                dg = torch.cat([dg[..., :gc * k] + back[..., nf:].to(dt),
                                dg[..., gc * k:]], dim=-1)
        if j % per == 0:
            d_s = d_s + pend
        ds = d_s
    return ds.reshape(d_out.shape).contiguous(), dU, dLFF


def rrdb_trunk_bwd(packed_t, growths, d_out, *, gc: int, num_convs: int,
                   rdb_scale: float = 0.2, rrdb_scale: float = 0.2,
                   rdbs_per_rrdb: int = 3, negative_slope: float = 0.2):
    """Backward-dx of the trunk: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``packed_t`` from
    ``pack_trunk_weights_bwd``, ``growths`` as the forward saved them,
    ``d_out`` (N, X, Y, Zl, nf) the trunk output's cotangent. Returns
    (d_x, dU, dLFF)."""
    global bwd_launches
    kw = dict(gc=gc, num_convs=num_convs, rdb_scale=rdb_scale,
              rrdb_scale=rrdb_scale, rdbs_per_rrdb=rdbs_per_rrdb,
              negative_slope=negative_slope)
    if d_out.device.type == "cpu":
        return rrdb_trunk_bwd_reference(packed_t, growths, d_out, **kw)
    J, nf, K = _check_bwd(packed_t, growths, d_out, gc, num_convs,
                          rdbs_per_rrdb, negative_slope)
    rows = _check_cuda(d_out, (d_out, growths, packed_t["conv"],
                               packed_t["lff"]), "trunk backward")
    N, X, Y, Z, _ = d_out.shape
    fn = _ctypes_fn("rdb_trunk_bwd",
                    f"windsr_rrdb_trunk_bwd_{_STORAGE[d_out.dtype]}", 8, 10)
    dev = d_out.device
    with torch.cuda.device(dev):
        d_x = torch.empty_like(d_out)
        dU = torch.empty_like(growths)
        dLFF = torch.empty(J, N, X * Y * Z, nf, dtype=d_out.dtype, device=dev)
        scratch = torch.empty(rows * (nf + gc * K), dtype=d_out.dtype,
                              device=dev)
        data = [t.data_ptr() for t in (growths, d_out, packed_t["conv"],
                                       packed_t["lff"], d_x, dU, dLFF,
                                       scratch)]
        vec = 0  # float32: no plan
        if d_out.dtype == torch.bfloat16:
            vec = plan_trunk_tc((N, X, Y, Z), nf, gc, num_convs,
                                data)["vec"]
        rc = fn(*data, N, X, Y, Z, nf, gc, num_convs, J, rdbs_per_rrdb, vec,
                rdb_scale, rrdb_scale, negative_slope,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RRDB trunk backward kernel launch failed: "
                           f"CUDA error {rc}")
    bwd_launches += 1
    return d_x, dU, dLFF
