"""Reference PyTorch checkpoints (``G_{it}.pth`` / ``D_{it}.pth``) into the
port's models, and the generator back out.

Counterpart of ``gan_sr_wind_field_tpu/utils/torch_import.py``. The
reference saves plain ``state_dict()`` pickles (GAN_models/baseGAN.py:
82-106); its conv weights are already in PyTorch's ``(O, I, kx, ky, kz)``
layout, so the keys map straight onto the port's ``Generator3D`` and
``Discriminator3D`` tensors:

    model.0.0.weight                          → feature_conv.weight
    model.1.module.{i}.RDBs.{j}.conv{k}.conv.0.weight
                                              → rrdbs.{i}.rdbs.{j}.convs.{k}.weight
    model.1.module.{i}.RDBs.{j}.LFF.{weight,bias}
                                              → rrdbs.{i}.rdbs.{j}.lff.{weight,bias}
    model.1.module.{num_rrdb}.0.weight        → lr_conv.weight
    model.{2+u}.1.0.weight                    → upconvs.{u}.weight  (u < ⌊log2 scale⌋)
    terrain_convs.{0,1}.0.weight              → terrain_conv{0,1}.weight
    hr_convs.0.0.weight (O, nf+tnf, k, k, k)  → hr_conv0_x / hr_conv0_t, split
                                                by input channel
    hr_convs.2.{weight,bias}                  → hr_conv1.{weight,bias}

    features.{i}.0.0.weight                   → blocks.{i}.conv.weight
    features.{i}.0.1.{weight,bias,running_mean,running_var}
                                              → blocks.{i}.conv.bn.{scale,bias,mean,var}
    features.{i}.1.…                          → blocks.{i}.strided_conv.…
    features.{4,5}.{0,1}.…                    → head_conv{0,1}.…  (enable_slicing)
    classifier.0.{weight,bias}                → fc0.{weight,bias}
    classifier.2.{weight,bias}                → fc1.{weight,bias}

Block 0's first conv has no norm, and a D with instance norm has no norm
entries outside its slicing head (the reference's ``InstanceNorm3d`` has
no affine and no running statistics, as JAX ``utils/torch_import.py:170,
178`` reads it). The horizontal_3D models are refused: the reference's
horizontal generator fails at its own init
(``Generator_3D_Resnet_ESRGAN.py:172-222``), so no such ``G.pth`` exists,
and its per-window modules have no key here. The reference flattens D's features
channel-first (c, x, y, z) and the port channel-last (x, y, z, c), so
``fc0``'s input axis is permuted. ``num_batches_tracked`` is not read.
Files are read with ``torch.load(weights_only=True)`` only; a missing key
or a tensor of the wrong shape raises and names the key.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping, Optional, Tuple

import torch

Tensors = "OrderedDict[str, torch.Tensor]"


def _check_3d(model, what: str) -> None:
    """ValueError for a horizontal_3D model: the reference layout is 3D
    only."""
    if any(t.dim() == 6 for t in model.state_dict().values()):
        raise ValueError(
            f"a reference {what} .pth holds 3D convs only: the reference "
            "cannot build a conv_mode='horizontal_3D' generator (its init "
            "fails), so there is no such checkpoint to read or write; use "
            "a continuation pack (.npz) or a checkpoint of the port")


def _take(sd: Mapping[str, torch.Tensor], key: str, shape) -> torch.Tensor:
    """``sd[key]`` as a float32 CPU tensor of ``shape``; KeyError or
    ValueError naming the key."""
    if key not in sd:
        raise KeyError(f"reference state_dict has no {key!r}")
    t = torch.as_tensor(sd[key]).detach().to("cpu", torch.float32)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"reference state_dict {key!r} has shape "
                         f"{tuple(t.shape)}, the model needs {tuple(shape)}")
    return t.contiguous()


def _generator_keys(generator):
    """(reference key, port key) of every generator tensor but the split
    hr_conv0, in the port's order."""
    g = generator
    pairs = [("model.0.0.weight", "feature_conv.weight")]
    for i in range(g.num_rrdb):
        for j in range(3):
            ref = f"model.1.module.{i}.RDBs.{j}."
            port = f"rrdbs.{i}.rdbs.{j}."
            pairs += [(ref + f"conv{k}.conv.0.weight",
                       port + f"convs.{k}.weight")
                      for k in range(g.num_rdb_convs - 1)]
            pairs += [(ref + "LFF.weight", port + "lff.weight"),
                      (ref + "LFF.bias", port + "lff.bias")]
    pairs.append((f"model.1.module.{g.num_rrdb}.0.weight", "lr_conv.weight"))
    pairs += [(f"model.{2 + u}.1.0.weight", f"upconvs.{u}.weight")
              for u in range(int(math.floor(math.log2(g.upscale))))]
    pairs += [("terrain_convs.0.0.weight", "terrain_conv0.weight"),
              ("terrain_convs.1.0.weight", "terrain_conv1.weight"),
              ("hr_convs.2.weight", "hr_conv1.weight"),
              ("hr_convs.2.bias", "hr_conv1.bias")]
    return pairs


def import_generator_state_dict(state_dict: Mapping[str, torch.Tensor],
                                generator) -> Tensors:
    """Reference ``G_{it}.pth`` state_dict → the port ``Generator3D``
    state_dict (float32, on the CPU, in the module's key order).
    ``generator`` is the target module: its configuration decides the
    layer counts and the shapes every tensor must have. A horizontal_3D
    generator raises ValueError."""
    _check_3d(generator, "G")
    want = {k: v.shape for k, v in generator.state_dict().items()}
    nf = generator.num_features
    out = {port: _take(state_dict, ref, want[port])
           for ref, port in _generator_keys(generator)}
    wx, wt = want["hr_conv0_x.weight"], want["hr_conv0_t.weight"]
    w0 = _take(state_dict, "hr_convs.0.0.weight",
               (wx[0], wx[1] + wt[1], *wx[2:]))
    out["hr_conv0_x.weight"] = w0[:, :nf].contiguous()
    out["hr_conv0_t.weight"] = w0[:, nf:].contiguous()
    return OrderedDict((k, out[k]) for k in want)


def export_generator_state_dict(params: Mapping[str, torch.Tensor],
                                generator) -> Tensors:
    """Port ``Generator3D`` state_dict → the reference's layout (float32 CPU
    tensors): the inverse of ``import_generator_state_dict``, key for key,
    hr_conv0's two parts concatenated along the input channels."""
    _check_3d(generator, "G")
    sd = OrderedDict()

    def cpu(t):
        return t.detach().to("cpu", torch.float32).contiguous()

    for ref, port in _generator_keys(generator):
        sd[ref] = cpu(params[port])
    sd["hr_convs.0.0.weight"] = torch.cat(
        [cpu(params["hr_conv0_x.weight"]), cpu(params["hr_conv0_t.weight"])],
        dim=1)
    return sd


def save_reference_checkpoint(path: str, params, generator) -> str:
    """Write a reference-loadable ``G_{it}.pth`` of the port generator
    weights ``params``; → ``path``."""
    torch.save(export_generator_state_dict(params, generator), path)
    return path


_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
       ("running_var", "var"))


def _discriminator_keys(discriminator):
    """(reference key, port key) of every discriminator tensor but
    ``fc0.weight``, in the order of the reference's modules."""
    d = discriminator
    pairs = []

    def conv(ref, port, norm):
        pairs.append((f"{ref}.0.weight", f"{port}.weight"))
        if norm:
            pairs.extend((f"{ref}.1.{r}", f"{port}.bn.{p}") for r, p in _BN)

    for i, blk in enumerate(d.blocks):
        conv(f"features.{i}.0", f"blocks.{i}.conv", blk.conv.bn is not None)
        conv(f"features.{i}.1", f"blocks.{i}.strided_conv",
             blk.strided_conv.bn is not None)
    if d.enable_slicing:
        n = len(d.blocks)
        for h in range(2):
            pairs.append((f"features.{n + h}.0.weight",
                          f"head_conv{h}.weight"))
            pairs.extend((f"features.{n + h}.1.{r}", f"head_conv{h}.bn.{p}")
                         for r, p in _BN)
    pairs += [("classifier.0.bias", "fc0.bias"),
              ("classifier.2.weight", "fc1.weight"),
              ("classifier.2.bias", "fc1.bias")]
    return pairs


def import_discriminator_state_dict(state_dict: Mapping[str, torch.Tensor],
                                    discriminator
                                    ) -> Tuple[Tensors, Tensors]:
    """Reference ``D_{it}.pth`` state_dict → (the port ``Discriminator3D``
    parameters, its batch-norm statistics), float32 on the CPU, each in the
    module's key order. A horizontal_3D discriminator raises
    ValueError."""
    d = discriminator
    _check_3d(d, "D")
    want = dict(d.state_dict())
    out = {port: _take(state_dict, ref, want[port].shape)
           for ref, port in _discriminator_keys(d)}
    X, Y, Z, C = d.feature_shape
    w = _take(state_dict, "classifier.0.weight", want["fc0.weight"].shape)
    out["fc0.weight"] = (w.reshape(-1, C, X, Y, Z).permute(0, 2, 3, 4, 1)
                         .reshape(w.shape).contiguous())
    buffers = {k for k, _ in d.named_buffers()}
    params = OrderedDict((k, out[k]) for k in want if k not in buffers)
    stats = OrderedDict((k, out[k]) for k in want if k in buffers)
    return params, stats


def export_discriminator_state_dict(params: Mapping[str, torch.Tensor],
                                    batch_stats: Mapping[str, torch.Tensor],
                                    discriminator) -> Tensors:
    """Port ``Discriminator3D`` parameters and statistics → the reference's
    layout: the inverse of ``import_discriminator_state_dict``, with each
    batch norm's ``num_batches_tracked`` written as 0 so that the
    reference's modules load it strictly."""
    d = discriminator
    _check_3d(d, "D")
    src = {**params, **batch_stats}

    def cpu(t):
        return t.detach().to("cpu", torch.float32).contiguous()

    sd = OrderedDict()
    X, Y, Z, C = d.feature_shape
    for ref, port in _discriminator_keys(d):
        sd[ref] = cpu(src[port])
        if ref.endswith(".running_var"):
            sd[ref[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    w = cpu(src["fc0.weight"])
    sd["classifier.0.weight"] = (w.reshape(-1, X, Y, Z, C)
                                 .permute(0, 4, 1, 2, 3).reshape(w.shape)
                                 .contiguous())
    return sd


def _load_state_dict(path: str):
    """A ``.pth`` state_dict, unpickling tensors and containers only."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(generator, g_path: str, discriminator=None,
                              d_path: Optional[str] = None):
    """Read reference ``.pth`` files → (params_G, params_D or None,
    batch_stats_D or None), port state_dicts on the CPU."""
    params_G = import_generator_state_dict(_load_state_dict(g_path),
                                           generator)
    params_D = stats_D = None
    if d_path is not None:
        if discriminator is None:
            raise ValueError("d_path given but no discriminator module")
        params_D, stats_D = load_reference_discriminator(discriminator,
                                                         d_path)
    return params_G, params_D, stats_D


def load_reference_discriminator(discriminator, d_path: str):
    """Read a reference ``D_{it}.pth`` alone → (params_D, batch_stats_D):
    the discriminator warm start beside a generator from another source
    (``env.discriminator_load_path``, reference baseGAN.load_model:52-60)."""
    return import_discriminator_state_dict(_load_state_dict(d_path),
                                           discriminator)
