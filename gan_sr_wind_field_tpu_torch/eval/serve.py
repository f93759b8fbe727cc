"""Serving API for a trained generator, on the CUDA card by default.

    sr = WindFieldSR.from_continuation(cfg, "docs/evidence/milestone9k_continuation_9000.npz")
    sr = WindFieldSR.from_checkpoint(cfg, "runs/<run>/ckpt_6016", x, y)
    hr_uvw = sr.upscale(lr_field, z_terrain)        # model (normalized) space
    hr_uvw = sr.upscale_tiled(lr_field, z_terrain, tile=16, overlap=4)
    hr_ms = sr.upscale_physical(lr_uvw_ms, z_raw)   # m/s in, m/s out

Counterpart of ``gan_sr_wind_field_tpu/eval/serve.py:WindFieldSR``. The
forward runs the RRDB trunk as the trunk kernel (``models/fused_apply.py``)
whenever the geometry allows it (3D convs, 1×1×1 LFF), and hr_conv0 as the
HR-head kernel (``ops/hr_head.py``) when the configuration sets
``use_pallas_head`` or ``use_pallas_head_nograd`` beside
``use_fused_trunk``: serving is a forward without a gradient. On a CUDA
device the constructor builds the kernels it will launch, so the first
request pays no build.

``upscale_tiled`` super-resolves a field of any horizontal extent in
overlapping tiles blended with a separable cosine window (tile and overlap
in LR pixels), as the JAX package does: the volumes are uploaded once,
each batch of tiles is cut on the device, run through the same forward and
blended into float32 accumulators there, and the blended volume is
downloaded once. The HTTP server tiles through its micro-batcher instead
(``server.py:tiled_upscale_via``), so that tiles batch with other traffic.

With ``mesh`` (``parallel/mesh.py``) serving is SPMD, as JAX's
``WindFieldSR(mesh=)`` shards a batch over its data axis and full volumes
over its spatial axis: every rank passes the whole batch to ``upscale``,
which pads it to a multiple of the data axis (``pad_batch_to``), runs this
rank's rows through the same forward and kernels, and gathers the rows
from every rank. On a spatial axis each rank runs its x slab of its rows,
every conv with its x halo, so that one forward spans the data row's
cards; the output is gathered along x, then over rows. On a model axis
each rank holds its output channels of every leaf JAX shards
(``parallel/model.py``) and every sharded conv gathers its output over the
model group, so each model rank's rows come out whole. On a model or
spatial axis, as JAX's ``dp_only`` rule says, the trunk and head kernels
stay off, and int8 serving raises (JAX ``eval/serve.py:133-136, 150-156``).
``upscale_tiled`` on a mesh takes the host loop through ``upscale``, as
JAX's does.

``quantize`` and ``quantize_trunk`` calibrate the int8 serving paths
(``ops/quant.py``, ``ops/quant_trunk.py``, through the port's int8 conv
kernel) on representative LR fields; every later ``upscale``,
``upscale_tiled`` and ``upscale_physical`` runs the quantized forward until
``dequantize``. Both are opt-in, as in the JAX package.

``upscale`` is three spans (``utils/spans.py``): ``serve.h2d`` (the
upload), ``serve.generate`` (the forward's launches, also of each batch of
tiles) and ``serve.d2h`` (the download, which waits for the device).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.transform import (
    _stat,
    lr_channel_names,
    physical_to_model_inputs,
)
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.fused_apply import (
    generate_fused,
    head_features_fused,
    head_kernel_flags,
    trunk_input_features,
)
from gan_sr_wind_field_tpu_torch.models.generator import empty_generator
from gan_sr_wind_field_tpu_torch.ops.hr_head import pack_head_weights
from gan_sr_wind_field_tpu_torch.ops.kernels import build
from gan_sr_wind_field_tpu_torch.ops.quant import (
    head_input_amax,
    quantize_split_head,
    scales_from_amax,
)
from gan_sr_wind_field_tpu_torch.ops.quant_trunk import (
    quantize_trunk as _quantize_trunk,
)
from gan_sr_wind_field_tpu_torch.ops.quant_trunk import trunk_reference_amax
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    trunk_fusable,
)
from gan_sr_wind_field_tpu_torch.parallel.collectives import gather_rows
from gan_sr_wind_field_tpu_torch.parallel.halo import gather_x
from gan_sr_wind_field_tpu_torch.parallel.mesh import pad_batch_to
from gan_sr_wind_field_tpu_torch.parallel.model import sharded_keys
from gan_sr_wind_field_tpu_torch.train.checkpoint import load_generator_state
from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils import spans
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax


def _cosine_window(n: int) -> np.ndarray:
    """Raised-cosine blending profile, 1.0 in the middle."""
    t = (np.arange(n) + 0.5) / n
    return 0.5 - 0.5 * np.cos(2 * np.pi * t)


class WindFieldSR:
    def __init__(self, cfg, params, device=None, norm_stats=None,
                 mesh=None):
        """``params``: a port ``Generator3D`` state_dict (see
        ``utils/jax_params.py`` for weights from the JAX package).
        ``norm_stats``: the training data's normalization factors (a
        ``NormStats``-like object or dict), needed by ``upscale_physical``.
        ``mesh``: a mesh to shard each batch over, its rows over the data
        axis, its x over a spatial axis and G's output channels over a
        model axis (not an idle rank's); ``params`` are whole on every
        rank, each takes its channels.
        """
        if mesh is not None and mesh.idle:
            raise ValueError("an idle rank of the mesh serves nothing")
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scale = cfg.scale
        self.norm_stats = norm_stats
        g = cfg.gan_config
        self.lr_channels = lr_channel_names(
            g.include_pressure, g.include_z_channel,
            g.include_above_ground_channel,
        )
        self.G = empty_generator(cfg, device=self.device).eval()
        self.G.load_state_dict(params, strict=True)
        G = self.G
        self.slab = None if mesh is None else mesh.slab()
        channels = None if mesh is None else mesh.channels()
        if channels is not None:
            # this rank's output channels of each leaf JAX shards
            keys = sharded_keys(params, mesh.model)
            with torch.no_grad():
                for k, p in G.named_parameters():
                    if k in keys:
                        p.data = channels.cut(p.data)
            G.shard_channels(channels, keys)
        if self.slab is not None or channels is not None:
            logging.getLogger("status").info(
                f"mesh {mesh.shape}: serving runs the modules (on x slabs "
                "over a spatial axis, on output-channel shares over a model "
                "axis); the trunk and HR-head kernels are off")
        self.packed = None
        if self.slab is None and channels is None and trunk_fusable(
                G.num_rdb_convs, G.lff_kern_size, G.conv_mode):
            self.packed = pack_trunk_weights(G.rrdbs, G.dtype, self.device)
        self.head_packed = None
        if (self.packed is not None and head_kernel_flags(cfg)[1]
                and G.negative_slope > 0):
            self.head_packed = pack_head_weights(
                G.hr_conv0_x.weight, G.hr_conv0_t.weight, G.dtype,
                self.device)
        if self.device.type == "cuda":
            build.warm((["rdb_trunk"] if self.packed is not None else [])
                       + (["hr_head"] if self.head_packed is not None
                          else []))
        self.qhead = None   # set by quantize()
        self.qtrunk = None  # set by quantize_trunk()

    @classmethod
    def from_continuation(cls, cfg, path: str, use_ema: bool = True,
                          device=None, norm_stats=None):
        """Serve the generator weights of a continuation pack; the EMA slot
        is preferred when the pack has one and ``use_ema``."""
        pack = load_continuation(path)
        tree = pack["params_G_ema"] if use_ema else None
        if tree is None:
            tree = pack["params_G"]
        return cls(cfg, params_from_jax(tree), device=device,
                   norm_stats=norm_stats)

    @classmethod
    def from_checkpoint(cls, cfg, path: str, x, y, use_ema: bool = True,
                        device=None, norm_stats=None):
        """Serve a trained generator: a port checkpoint folder
        (``ckpt_{it}``), a continuation pack (a path ending ``.npz``, see
        ``from_continuation``) or a reference ``G_{it}.pth``
        (``utils/torch_import.py``). The EMA slot is preferred when there
        is one and ``use_ema``; a ``.pth`` has none. ``x``/``y`` are the
        training grid's coordinates, as ``WindFieldGAN`` takes them.

        The checkpoint's weights are restored into a state built at the
        training patch (D's classifier depends on it; G on no size), on
        ``device``, whatever device saved it."""
        if path.endswith(".npz"):
            return cls.from_continuation(cfg, path, use_ema=use_ema,
                                         device=device, norm_stats=norm_stats)
        state = load_generator_state(
            cfg, WindFieldGAN(cfg, x, y, device=device), path)
        params = state.params_G_ema if use_ema else None
        if params is None:
            params = state.params_G
        return cls(cfg, params, device=device, norm_stats=norm_stats)

    def _check_quantizable(self) -> None:
        """The precondition JAX ``_generate_q`` raises on: the trunk-kernel
        path (``use_fused_trunk`` and a geometry the kernel takes), and no
        model or spatial axis."""
        if self.slab is not None or self.G.channels is not None:
            raise ValueError(
                "quantized serving is a single-device path; use tiling "
                "instead of a model/spatial mesh")
        if not (getattr(self.cfg, "use_fused_trunk", False)
                and self.packed is not None):
            raise ValueError(
                "quantized serving needs the single-device fused-trunk "
                "path (use_fused_trunk=True, a geometry the trunk kernel "
                "takes)")

    def _calibration_chunks(self, calib_lr, batch: int):
        """calib_lr (n, x, y, zl, C) or one field, on the device in chunks
        of ``batch``, the last padded with copies of its last field (the
        abs-max ignores duplicates)."""
        calib_lr = np.asarray(calib_lr, np.float32)
        if calib_lr.ndim == 4:
            calib_lr = calib_lr[None]
        for i in range(0, calib_lr.shape[0], batch):
            chunk = calib_lr[i:i + batch]
            if chunk.shape[0] < batch:
                pad = batch - chunk.shape[0]
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            yield torch.from_numpy(chunk).to(self.device)

    @torch.inference_mode()
    def quantize(self, calib_lr, batch: int = 8):
        """Calibrate and turn on the int8 HR-head serving path
        (``ops/quant.py``): per-channel abs-max of hr_conv0's input over
        ``calib_lr`` (representative LR fields, (n, x, y, zl, C); the input
        depends on LR alone), in padded batches of ``batch``. Later
        forwards run hr_conv0's x-part in int8 (one launch of the int8
        head-pair kernel) and keep the trunk kernel; the HR-head kernel is off
        while it is on. ``dequantize()`` returns to the exact path.
        Raises ValueError without the trunk-kernel path."""
        self._check_quantizable()
        amax = None
        for chunk in self._calibration_chunks(calib_lr, batch):
            a = head_input_amax(
                head_features_fused(self.G, chunk, self.packed)).cpu().numpy()
            amax = a if amax is None else np.maximum(amax, a)
        wx = self.G.hr_conv0_x.weight.detach().float().permute(2, 3, 4, 1, 0)
        self.qhead = quantize_split_head(wx, scales_from_amax(amax))
        if self.device.type == "cuda":
            build.warm(["conv_int8"])
        return self.qhead

    @torch.inference_mode()
    def quantize_trunk(self, calib_lr, batch: int = 8):
        """Calibrate and turn on the int8 trunk serving path
        (``ops/quant_trunk.py``), with ``quantize``'s calibration contract:
        the abs-max of every tensor the int8 trunk quantizes, from the
        float32 trunk with plain convs on the trunk's input. Composes with
        ``quantize``. Raises ValueError without the trunk-kernel path."""
        self._check_quantizable()
        G = self.G
        params = {k: v.detach() for k, v in G.state_dict().items()}
        geom = dict(num_rrdb=G.num_rrdb, num_convs=G.num_rdb_convs,
                    lff_kern=G.lff_kern_size,
                    rdb_scale=G.rdb_residual_scaling,
                    rrdb_scale=G.rrdb_residual_scaling,
                    negative_slope=G.negative_slope)
        ax = ac = None
        for chunk in self._calibration_chunks(calib_lr, batch):
            _, a_x, a_c = trunk_reference_amax(
                params, trunk_input_features(G, chunk), **geom)
            a_x, a_c = a_x.cpu().numpy(), a_c.cpu().numpy()
            ax = a_x if ax is None else np.maximum(ax, a_x)
            ac = a_c if ac is None else np.maximum(ac, a_c)
        self.qtrunk = _quantize_trunk(params, torch.from_numpy(ax),
                                      torch.from_numpy(ac), **geom)
        if self.device.type == "cuda":
            build.warm(["conv_int8"])
        return self.qtrunk

    def dequantize(self) -> None:
        """Back to the exact serving forward."""
        self.qhead = None
        self.qtrunk = None

    @torch.inference_mode()
    def _generate(self, lr: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        with spans.span("serve.generate"):
            if self.qhead is not None or self.qtrunk is not None:
                return generate_fused(self.G, lr, z, self.packed,
                                      qhead=self.qhead, qtrunk=self.qtrunk)
            if self.slab is not None:
                return gather_x(self.G(*(self.slab.cut(t) for t in (lr, z)),
                                       slab=self.slab), self.slab)
            if self.packed is None:
                return self.G(lr, z)
            return generate_fused(self.G, lr, z, self.packed,
                                  self.head_packed,
                                  head=self.head_packed is not None)

    def upscale(self, lr, z_terrain) -> np.ndarray:
        """lr: (x, y, zl, C) or batched; returns (X, Y, zl, 3) float32. On
        a mesh every rank passes the same batch and gets all of it back."""
        lr = np.asarray(lr, np.float32)
        z_terrain = np.asarray(z_terrain, np.float32)
        squeeze = lr.ndim == 4
        if squeeze:
            lr, z_terrain = lr[None], z_terrain[None]
        if self.mesh is None:
            with spans.span("serve.h2d"):
                lr_d = torch.from_numpy(lr).to(self.device)
                z_d = torch.from_numpy(z_terrain).to(self.device)
            out = self._generate(lr_d, z_d)
        else:
            lr, n = pad_batch_to(lr, self.mesh.size)
            z_terrain, _ = pad_batch_to(z_terrain, self.mesh.size)
            rows = self.mesh.rows(lr.shape[0])
            mine = self._generate(
                torch.from_numpy(lr[rows]).to(self.device),
                torch.from_numpy(z_terrain[rows]).to(self.device))
            out = gather_rows(mine, self.mesh.data_group, rows,
                              lr.shape[0])[:n]
        with spans.span("serve.d2h"):  # waits for the device too
            out = out.cpu().numpy()
        return out[0] if squeeze else out

    def upscale_physical(self, lr_uvw, z, pressure=None,
                         z_above_ground=None, tiled: bool = False,
                         **tile_kw) -> np.ndarray:
        """Physical units: LR wind in m/s and raw HR height ``z`` in, SR
        wind in m/s out, normalized with this instance's ``norm_stats``.
        ``tiled=True`` goes through ``upscale_tiled`` (one field) with
        ``tile_kw``."""
        if self.norm_stats is None:
            raise ValueError(
                "physical-units serving needs norm_stats (pass the "
                "training dataset's stats to WindFieldSR)"
            )
        g = self.cfg.gan_config
        lr, zt = physical_to_model_inputs(
            lr_uvw, z, self.norm_stats, self.scale,
            include_pressure=g.include_pressure,
            include_z_channel=g.include_z_channel,
            include_above_ground_channel=g.include_above_ground_channel,
            pressure=pressure, z_above_ground=z_above_ground,
        )
        sr = (self.upscale_tiled(lr, zt, **tile_kw) if tiled
              else self.upscale(lr, zt))
        return sr * _stat(self.norm_stats, "uvw_max")

    def upscale_tiled(self, lr, z_terrain, tile: int = 64, overlap: int = 16,
                      batch: int = 8) -> np.ndarray:
        """Overlap-tiled SR of one field of any horizontal extent.

        lr: (x, y, zl, C); z_terrain: (x·s, y·s, zl, 1); → (x·s, y·s, zl,
        3) float32. ``tile`` and ``overlap`` are in LR pixels; tiles run
        through the generator ``batch`` at a time, the last batch padded
        with copies of its last tile under a zero mask. A field no larger
        than one tile is one ``upscale``; where one side is smaller than
        the tile, the tile shrinks to it (and an overlap that no longer
        fits to a quarter of it)."""
        s = self.scale
        X, Y = lr.shape[0], lr.shape[1]
        if X <= tile and Y <= tile:
            return self.upscale(lr, z_terrain)
        tile, win, coords = _tiling(X, Y, tile, overlap, batch, s)
        if self.mesh is not None:
            return self._upscale_tiled_host(lr, z_terrain, coords, tile,
                                            batch, win)
        dev = self.device
        lr_d = torch.from_numpy(np.ascontiguousarray(lr, np.float32)).to(dev)
        zt_d = torch.from_numpy(
            np.ascontiguousarray(z_terrain, np.float32)).to(dev)
        win_d = torch.from_numpy(win).to(dev)
        n = len(coords)
        padded = coords + [coords[-1]] * (-n % batch)
        origins = torch.tensor(padded, dtype=torch.int64).to(dev)
        ts = tile * s
        ax, axs = (torch.arange(k, device=dev) for k in (tile, ts))
        out = torch.zeros((X * s, Y * s, lr.shape[2], 3), dtype=torch.float32,
                          device=dev)
        weight = torch.zeros((X * s, Y * s, 1, 1), dtype=torch.float32,
                             device=dev)
        for i in range(0, n, batch):
            x0, y0 = origins[i:i + batch, 0], origins[i:i + batch, 1]
            lr_b = lr_d[(x0[:, None, None] + ax[None, :, None]),
                        (y0[:, None, None] + ax[None, None, :])]
            z_b = zt_d[(s * x0[:, None, None] + axs[None, :, None]),
                       (s * y0[:, None, None] + axs[None, None, :])]
            sr_b = self._generate(lr_b, z_b) * win_d
            # the padded tiles' mask is zero: they are left out
            for j, (xj, yj) in enumerate(coords[i:i + batch]):
                sl = (slice(xj * s, xj * s + ts), slice(yj * s, yj * s + ts))
                out[sl] += sr_b[j]
                weight[sl] += win_d
        return (out / weight.clamp_min(1e-12)).cpu().numpy()

    def _upscale_tiled_host(self, lr, z_terrain, coords, tile: int,
                            batch: int, win: np.ndarray) -> np.ndarray:
        """The same tiling as a host loop: batches of tiles through
        ``upscale`` and blended in numpy. The path on a mesh, as in the JAX
        package, and the yardstick the tests hold ``upscale_tiled``
        against."""
        s = self.scale
        X, Y = lr.shape[0], lr.shape[1]
        out = np.zeros((X * s, Y * s, lr.shape[2], 3), np.float32)
        weight = np.zeros((X * s, Y * s, 1, 1), np.float32)
        for i in range(0, len(coords), batch):
            chunk = coords[i:i + batch]
            lr_b = np.stack(
                [lr[x0:x0 + tile, y0:y0 + tile] for x0, y0 in chunk])
            z_b = np.stack([
                z_terrain[x0 * s:(x0 + tile) * s, y0 * s:(y0 + tile) * s]
                for x0, y0 in chunk
            ])
            if len(chunk) < batch:  # pad to the batch's shape
                pad = batch - len(chunk)
                lr_b = np.concatenate([lr_b, np.repeat(lr_b[-1:], pad, 0)])
                z_b = np.concatenate([z_b, np.repeat(z_b[-1:], pad, 0)])
            sr_b = self.upscale(lr_b, z_b)
            for j, (x0, y0) in enumerate(chunk):
                sl = np.s_[x0 * s:(x0 + tile) * s, y0 * s:(y0 + tile) * s]
                out[sl] += sr_b[j] * win
                weight[sl] += win
        return out / np.maximum(weight, 1e-12)


def _tiling(X: int, Y: int, tile: int, overlap: int, batch: int, s: int):
    """The tiles of an X × Y LR field: (tile, the HR window (tile·s,
    tile·s, 1, 1) float32, the LR origins in order). Raises ValueError for
    an overlap that does not fit the tile or a batch below 1."""
    if min(X, Y) < tile:
        # one side smaller than the tile: clamp so that origins stay >= 0;
        # an overlap that no longer fits degrades to a quarter
        tile = min(X, Y)
        if overlap >= tile:
            overlap = tile // 4
    step = tile - overlap
    if step <= 0:
        raise ValueError("overlap must be smaller than tile")
    if batch < 1:
        raise ValueError("batch must be >= 1")
    win1d = _cosine_window(tile * s)
    win = np.outer(win1d, win1d)[:, :, None, None].astype(np.float32)
    xs = sorted({min(x0, X - tile) for x0 in range(0, X, step)})
    ys = sorted({min(y0, Y - tile) for y0 in range(0, Y, step)})
    return tile, win, [(x0, y0) for x0 in xs for y0 in ys]
