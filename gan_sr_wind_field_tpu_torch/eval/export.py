"""Ahead-of-time generator export: one self-contained deployment artifact.

Counterpart of ``gan_sr_wind_field_tpu/eval/export.py``.
``export_generator`` writes the trained generator's eval-mode forward,
with its weights, as a ``torch.export`` program into one file that loads
and runs with PyTorch alone: no model code, config or checkpoint of this
package. The batch is a symbolic dimension, so one artifact serves any
batch; the LR/HR extent is static at the config's patch, as in JAX.

    from gan_sr_wind_field_tpu_torch.eval.export import load_exported
    sr = load_exported("generator.wsrx")        # on the card; device="cpu"
    hr = sr.upscale(lr, z_terrain)              # (b, X·s, Y·s, zl, 3)
    sr = load_exported("generator.wsrx", device="cpu").to("cuda")  # the same

The program is the generator on its plain path, aten convolutions only:
the port's CUDA kernels are bound with ctypes and cannot be traced, and
they would pin the artifact to this package's build, as the JAX package
keeps Mosaic custom calls out of its artifact. It is traced on the CPU
with the weights in float32 (cast to the compute dtype inside the
program, as the modules do); ``load_exported`` moves it to the device.

File layout, the JAX package's container: ``b"WSRX" | u32 header_len |
header JSON (utf-8) | payload``. The header carries JAX's keys (``scale``,
``lr_shape``, ``z_shape``, ``out_channels``, ``batch_polymorphic``,
``platforms``, ``lr_channels``, ``norm_stats``), ``torch_version`` in
place of ``jax_version``, and ``"payload": "torch.export"`` at
``format_version`` 2, so the JAX package's reader refuses this file
cleanly; ``read_header`` here reads versions 1 and 2, and
``load_exported`` names the JAX package's loader for a version-1 file.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.transform import (
    _stat,
    lr_channel_names,
    physical_to_model_inputs,
)
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.generator import empty_generator

_MAGIC = b"WSRX"
_FORMAT_VERSION = 2
_PAYLOAD = "torch.export"
# the symbolic batch's range; traced at 2, so that 1 is not specialised
_MAX_BATCH = 4096
_TRACE_BATCH = 2


class _Forward(torch.nn.Module):
    """The eval-mode generator as a two-argument module (lr, z_terrain)."""

    def __init__(self, G):
        super().__init__()
        self.G = G

    def forward(self, lr, z_terrain):
        return self.G(lr, z_terrain)


def _stats_dict(norm_stats) -> dict:
    stats = (dataclasses.asdict(norm_stats)
             if dataclasses.is_dataclass(norm_stats) else dict(norm_stats))
    return {k: float(v) for k, v in stats.items()}


def export_generator(cfg, params, path: str,
                     lr_size: Optional[Tuple[int, int]] = None,
                     batch_polymorphic: bool = True,
                     norm_stats=None) -> dict:
    """Write the generator of ``cfg`` with ``params`` (a port
    ``Generator3D`` state_dict, on any device) to ``path``.

    lr_size: the LR extent (x, y); defaults to the config's patch
    (slice_size // scale; a config without slicing must pass it).
    norm_stats: the training data's normalization factors, written into
    the header so that consumers can serve physical units. Returns the
    header that was written."""
    s = cfg.scale
    g = cfg.gan_config
    zl = g.number_of_z_layers
    cin = cfg.lr_num_channels
    if lr_size is None:
        if not g.enable_slicing:
            raise ValueError("a config without slicing has no patch: pass "
                             "lr_size")
        lr_size = (g.slice_size // s, g.slice_size // s)
    X, Y = (int(v) for v in lr_size)

    G = empty_generator(cfg, device="cpu").eval()
    G.load_state_dict({k: v.detach().to("cpu", torch.float32)
                       for k, v in params.items()}, strict=True)
    b = _TRACE_BATCH if batch_polymorphic else 1
    lr = torch.zeros((b, X, Y, zl, cin))
    z = torch.zeros((b, X * s, Y * s, zl, 1))
    dynamic = None
    if batch_polymorphic:
        batch = torch.export.Dim("batch", min=1, max=_MAX_BATCH)
        dynamic = ({0: batch}, {0: batch})
    with torch.no_grad():
        program = torch.export.export(_Forward(G), (lr, z),
                                      dynamic_shapes=dynamic)
    # each .to(dtype) traces an assert of the tensor's dtype and device:
    # it pins the tracing device (the CPU), and at full width these are a
    # fifth of the graph's nodes, which the loader deserializes one by one
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    program.graph_module.recompile()

    lead = "b" if batch_polymorphic else 1
    header = {
        "format_version": _FORMAT_VERSION,
        "payload": _PAYLOAD,
        "scale": s,
        "lr_shape": [lead, X, Y, zl, cin],
        "z_shape": [lead, X * s, Y * s, zl, 1],
        "out_channels": G.out_channels,
        "batch_polymorphic": bool(batch_polymorphic),
        "platforms": ["cpu", "cuda"],
        "torch_version": torch.__version__,
        "lr_channels": lr_channel_names(
            g.include_pressure, g.include_z_channel,
            g.include_above_ground_channel),
    }
    if norm_stats is not None:
        header["norm_stats"] = _stats_dict(norm_stats)
    hdr = json.dumps(header).encode("utf-8")
    payload = io.BytesIO()  # the archive's offsets count from its start
    torch.export.save(program, payload)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload.getbuffer())
    return header


class ExportedSR:
    """A loaded artifact: ``upscale(lr, z_terrain)`` as
    ``WindFieldSR.upscale`` (an unbatched (x, y, zl, C) input is batched
    and squeezed back), on ``device``."""

    def __init__(self, program, header: dict, device: torch.device):
        self.program = program
        self._module = program.module()
        self.header = header
        self.device = device
        self.scale = header["scale"]
        self.norm_stats = header.get("norm_stats")
        self.lr_channels = header.get("lr_channels")

    def to(self, device) -> "ExportedSR":
        """The same artifact on ``device``: its program moved there (the
        weights and the device arguments of its nodes)."""
        from torch.export.passes import move_to_device_pass

        dev = torch.device(device)
        return ExportedSR(move_to_device_pass(self.program, dev), self.header,
                          dev)

    def upscale(self, lr, z_terrain) -> np.ndarray:
        lr = np.asarray(lr, np.float32)
        z_terrain = np.asarray(z_terrain, np.float32)
        squeeze = lr.ndim == 4
        if squeeze:
            lr, z_terrain = lr[None], z_terrain[None]
        if (not self.header["batch_polymorphic"]
                and lr.shape[0] != self.header["lr_shape"][0]):
            raise ValueError(
                f"artifact was exported with static batch "
                f"{self.header['lr_shape'][0]}, got {lr.shape[0]}")
        with torch.inference_mode():
            out = self._module(torch.from_numpy(lr).to(self.device),
                               torch.from_numpy(z_terrain).to(self.device))
        out = out.cpu().numpy()
        return out[0] if squeeze else out

    def upscale_physical(self, lr_uvw, z, pressure=None,
                         z_above_ground=None) -> np.ndarray:
        """LR wind in m/s and raw HR height in, SR wind in m/s out, with
        the channel layout and norm_stats of the artifact's header."""
        if self.norm_stats is None or "lr_channels" not in self.header:
            raise ValueError(
                "artifact lacks norm_stats/lr_channels (re-export with "
                "norm_stats to enable physical-units serving)")
        names = self.header["lr_channels"]
        lr, zt = physical_to_model_inputs(
            lr_uvw, z, self.norm_stats, self.scale,
            include_pressure="p" in names,
            include_z_channel=("z" in names or "z_relative" in names),
            include_above_ground_channel="z_above_ground" in names,
            pressure=pressure, z_above_ground=z_above_ground,
        )
        return self.upscale(lr, zt) * _stat(self.norm_stats, "uvw_max")


def _read(f, path: str):
    magic = f.read(4)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a WSRX artifact (magic {magic!r})")
    (hdr_len,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hdr_len).decode("utf-8"))
    if header["format_version"] > _FORMAT_VERSION:
        raise ValueError(
            f"{path}: format v{header['format_version']} is newer than "
            f"this reader (v{_FORMAT_VERSION})")
    return header


def read_header(path: str) -> dict:
    """The artifact's metadata only (scale, shapes, norm_stats,
    lr_channels), of either format version; nothing is deserialized."""
    with open(path, "rb") as f:
        return _read(f, path)


def load_exported(path: str, device=None) -> ExportedSR:
    """Load an artifact written by ``export_generator`` onto ``device``
    (default the card). A version-1 artifact holds a ``jax.export``
    payload: it raises, naming the JAX package's loader."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        header = _read(f, path)
        if header.get("payload") != _PAYLOAD:
            raise ValueError(
                f"{path}: a format v{header['format_version']} artifact "
                f"with a jax.export payload; load it with the JAX "
                f"package's gan_sr_wind_field_tpu.eval.export.load_exported")
        program = torch.export.load(f)
    sr = ExportedSR(program, header, torch.device("cpu"))
    return sr if dev.type == "cpu" else sr.to(dev)
