"""Network interpolation: blend two trained generators.

Counterpart of ``gan_sr_wind_field_tpu/eval/interp.py``, the ESRGAN
deployment technique (Wang et al. 2018, §3.4): every generator parameter
is interpolated between a PSNR-oriented model and a GAN-trained one,

    theta = alpha * theta_gan + (1 - alpha) * theta_psnr,

trading sharpness against fidelity without retraining. The command line
writes a serving artifact (``eval/export.py``):

    python -m gan_sr_wind_field_tpu_torch.eval.interp --cfg run_cfg.ini \\
        --gan ckpt_or_pack --psnr ckpt_or_pack --alpha 0.8 \\
        --out blended.wsrx [--stats_from ARTIFACT.wsrx] [--device cpu]

Both weights must come from the same architecture: continuation packs
(``.npz``), port checkpoint folders (``ckpt_{it}``) or reference
``G_{it}.pth`` files, anything ``WindFieldSR.from_checkpoint`` takes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.config import load_config
from gan_sr_wind_field_tpu_torch.eval.export import (
    export_generator,
    read_header,
)
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR


def blend_params(params_gan, params_psnr, alpha: float) -> dict:
    """alpha · params_gan + (1 − alpha) · params_psnr, tensor by tensor
    (two port state_dicts), in float32 and cast back to each tensor's
    dtype; raises ValueError on different keys or shapes or alpha outside
    [0, 1] (0 is the PSNR model, 1 the GAN model)."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if list(params_gan) != list(params_psnr) or any(
            params_gan[k].shape != params_psnr[k].shape for k in params_gan):
        raise ValueError(
            "checkpoints have different parameter structures: network "
            "interpolation needs two models of the same architecture")
    out = {}
    for k, g in params_gan.items():
        a = torch.tensor(alpha, dtype=torch.float32, device=g.device)
        p = params_psnr[k].to(g.device)
        out[k] = (a * g.to(torch.float32)
                  + (1 - a) * p.to(torch.float32)).to(g.dtype)
    return out


def interpolated_sr(cfg, path_gan: str, path_psnr: str, alpha: float, x, y,
                    norm_stats=None, device=None) -> WindFieldSR:
    """A ``WindFieldSR`` serving the blended generator of two weights
    ``WindFieldSR.from_checkpoint`` reads."""
    sr_gan = WindFieldSR.from_checkpoint(cfg, path_gan, x, y, device=device)
    sr_psnr = WindFieldSR.from_checkpoint(cfg, path_psnr, x, y,
                                          device=device)
    params = blend_params(sr_gan.G.state_dict(), sr_psnr.G.state_dict(),
                          alpha)
    return WindFieldSR(cfg, params, device=device, norm_stats=norm_stats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Blend two trained generators (ESRGAN network "
                    "interpolation) into a serving artifact")
    p.add_argument("--cfg", required=True, help="architecture config INI")
    p.add_argument("--gan", required=True,
                   help="GAN-trained weights (.npz pack, ckpt_{it} or "
                        "G .pth)")
    p.add_argument("--psnr", required=True,
                   help="PSNR-oriented weights (pixel-dominant run)")
    p.add_argument("--alpha", type=float, required=True,
                   help="GAN weight in [0,1]: 0 = pure PSNR, 1 = pure GAN")
    p.add_argument("--out", required=True, help="output .wsrx artifact")
    p.add_argument("--stats_from", default=None, metavar="ARTIFACT.wsrx",
                   help="copy norm_stats from an existing export (of either "
                        "package) so that the blended artifact serves "
                        "physical units (weights carry no normalization "
                        "stats)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = load_config(args.cfg)
    g = cfg.gan_config
    # the coordinates shape only the default patch; the artifact's extent
    # is the config's patch (128 without slicing, as in the JAX package)
    n = g.slice_size if g.enable_slicing else 128
    x = np.arange(n, dtype=np.float32) * 150.0
    stats = None
    if args.stats_from:
        stats = read_header(args.stats_from).get("norm_stats")
        if stats is None:
            raise SystemExit(
                f"{args.stats_from} carries no norm_stats: re-export it "
                "with stats to use --stats_from")
    sr = interpolated_sr(cfg, args.gan, args.psnr, args.alpha, x, x,
                         norm_stats=stats, device=args.device)
    header = export_generator(cfg, sr.G.state_dict(), args.out,
                              lr_size=(n // cfg.scale, n // cfg.scale),
                              norm_stats=stats)
    print(f"blended alpha={args.alpha} -> {args.out} "
          f"(platforms {header['platforms']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
