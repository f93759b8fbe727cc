"""Export a compact committable continuation pack from a port checkpoint.

    python -m gan_sr_wind_field_tpu_torch.scripts.export_continuation \\
        RUN_FOLDER [--ckpt CKPT_DIR] [--out PACK.npz] [--no-ema] [--fp32]
        [--device cpu]

Counterpart of the root ``scripts/export_continuation.py``, on the port's
``ckpt_<it>/state.pt`` checkpoints. RUN_FOLDER holds the run's
``config.ini`` snapshot (``run.py`` writes one for every run); the
checkpoint is ``--ckpt`` or the newest ``ckpt_*`` in RUN_FOLDER. The pack
(``train/continuation.py``'s format, bf16 by default, with the EMA unless
``--no-ema``) is the weight format the port shares with the JAX package:
either one warm-starts from it with

    generator_load_path = <pack.npz>   # in the next leg's [ENV]
    load_model_from_save = True

which loads the weights and ``it`` (the schedules go on; the Adam moments
start again from zero). The pack's meta names the source checkpoint, the
config and the run's name; ``--fp32`` re-packs in float32 without them,
as the JAX script does. The restore runs on the card unless ``--device``
asks for another device (the pack is the same from either).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_folder")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: latest ckpt_* in run)")
    ap.add_argument("--out", default=None,
                    help="output .npz (default: <run>/continuation_<it>.npz)")
    ap.add_argument("--no-ema", action="store_true",
                    help="drop the EMA slot (halves G storage)")
    ap.add_argument("--fp32", action="store_true",
                    help="store float32 instead of bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device of the restore; default the CUDA "
                         "card, 'cpu' only when asked")
    args = ap.parse_args(argv)

    import numpy as np

    from gan_sr_wind_field_tpu_torch.config import Config
    from gan_sr_wind_field_tpu_torch.device import resolve_device
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
    from gan_sr_wind_field_tpu_torch.train.continuation import (
        pack_from_state,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    cfg_path = os.path.join(args.run_folder, "config.ini")
    cfg = Config.from_ini(cfg_path)
    path = args.ckpt or ckpt.latest_checkpoint(args.run_folder)
    if path is None:
        raise SystemExit(f"no ckpt_* under {args.run_folder}")

    g = cfg.gan_config
    # physics-grid coordinates only feed the loss: any monotone grid of
    # the right extent works for a restore-and-pack
    size = g.slice_size if g.enable_slicing else 128
    x = np.arange(size, dtype=np.float32)
    gan = WindFieldGAN(cfg, x, x, device=resolve_device(args.device))
    # the weights only: a checkpoint of any device type restores
    state = ckpt.restore_checkpoint(path, ckpt.training_example(cfg, gan),
                                    restore_rng=False)

    it = int(state.it)
    out = args.out or os.path.join(args.run_folder, f"continuation_{it}.npz")
    if args.fp32:
        # float32 (rare; bf16 keeps packs committable), without the meta
        # of the bf16 pack, as the JAX script re-packs
        pack_from_state(out, state, include_ema=not args.no_ema,
                        store_dtype="float32")
    else:
        pack_from_state(
            out, state, include_ema=not args.no_ema,
            extra_meta={
                "source_ckpt": os.path.abspath(path),
                "config": os.path.abspath(cfg_path),
                "name": cfg.name,
            },
        )
    mb = os.path.getsize(out) / 1e6
    print(f"wrote {out} ({mb:.1f} MB, it={it})")


if __name__ == "__main__":
    main()
