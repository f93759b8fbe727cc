"""Checkpoint and resume of the port's full training state.

Counterpart of ``gan_sr_wind_field_tpu/train/checkpoint.py`` in the port's
own format (Orbax checkpoints of the JAX package are not read; the ``.npz``
continuation pack is the format the two packages share). One folder
``ckpt_{it}`` per save holds ``state.pt``: every tensor of
``GANTrainState`` (G, D, D's statistics, the frozen D, both Adam states,
the EMA), ``it``, and the state of the ``torch.Generator``, so a resume is
bit-exact. It is written with ``torch.save`` (to a temporary name, then
renamed) and read with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from gan_sr_wind_field_tpu_torch.train.gan import AdamState, GANTrainState

FORMAT_VERSION = 1
STATE_FILE = "state.pt"
_TREES = ("params_G", "params_D", "batch_stats_D", "params_D_frozen",
          "params_G_ema")


def _adam_to_dict(opt: AdamState) -> dict:
    return {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}


def save_checkpoint(run_folder: str, state: GANTrainState,
                    keep_last: int = 0) -> str:
    """Write a checkpoint for the state's current iteration; → its folder.

    ``keep_last`` > 0 prunes older ``ckpt_*`` folders down to that many
    (0 keeps all, as the reference does)."""
    it = int(state.it)
    path = os.path.abspath(os.path.join(run_folder, f"ckpt_{it}"))
    os.makedirs(path, exist_ok=True)
    blob = {t: getattr(state, t) for t in _TREES}
    blob.update(
        format_version=FORMAT_VERSION,
        it=it,
        opt_state_G=_adam_to_dict(state.opt_state_G),
        opt_state_D=_adam_to_dict(state.opt_state_D),
        rng_state=state.rng.get_state(),
    )
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if keep_last and keep_last > 0:
        its = sorted(
            int(m.group(1))
            for name in os.listdir(run_folder)
            if (m := re.fullmatch(r"ckpt_(\d+)", name))
        )
        for old in its[:-keep_last]:
            shutil.rmtree(os.path.join(run_folder, f"ckpt_{old}"),
                          ignore_errors=True)
    return path


def checkpoint_bytes(path: str) -> int:
    """The size of the checkpoint at ``path`` on disk."""
    return os.path.getsize(os.path.join(path, STATE_FILE))


def latest_checkpoint(run_folder: str) -> Optional[str]:
    if not os.path.isdir(run_folder):
        return None
    best_it, best = -1, None
    for name in os.listdir(run_folder):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if (m and int(m.group(1)) > best_it
                and os.path.isfile(os.path.join(run_folder, name,
                                                STATE_FILE))):
            best_it, best = int(m.group(1)), os.path.join(run_folder, name)
    return os.path.abspath(best) if best else None


def restore_checkpoint(path: str, example_state: GANTrainState
                       ) -> GANTrainState:
    """Restore onto the devices of ``example_state`` (a fresh state of the
    same configuration).

    The EMA slot is reconciled across configurations as the JAX package
    does: a checkpoint with an EMA keeps it under a configuration without
    one, and one without an EMA seeds it from the restored G when the
    configuration has one."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if blob.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"checkpoint {path} has format "
                         f"{blob['format_version']} > {FORMAT_VERSION}")

    def like(tree, example):
        if tree is None:
            return None
        dev = next(iter(example.values())).device if example else "cpu"
        return {k: v.to(dev) for k, v in tree.items()}

    def adam(d, example: AdamState) -> AdamState:
        return AdamState(d["count"], like(d["mu"], example.mu),
                         like(d["nu"], example.nu))

    ex = example_state
    params_G = like(blob["params_G"], ex.params_G)
    ema = like(blob["params_G_ema"], ex.params_G)
    if ema is None and ex.params_G_ema is not None:
        ema = {k: v.clone() for k, v in params_G.items()}
    rng = torch.Generator(device=ex.rng.device)
    rng.set_state(blob["rng_state"])
    return GANTrainState(
        params_G=params_G,
        params_D=like(blob["params_D"], ex.params_D),
        batch_stats_D=like(blob["batch_stats_D"], ex.batch_stats_D),
        params_D_frozen=like(blob["params_D_frozen"], ex.params_D) or {},
        opt_state_G=adam(blob["opt_state_G"], ex.opt_state_G),
        opt_state_D=adam(blob["opt_state_D"], ex.opt_state_D),
        it=int(blob["it"]),
        rng=rng,
        params_G_ema=ema,
    )
