"""Checkpoint and resume of the port's full training state.

Counterpart of ``gan_sr_wind_field_tpu/train/checkpoint.py`` in the port's
own format (Orbax checkpoints of the JAX package are not read; the ``.npz``
continuation pack is the format the two packages share). One folder
``ckpt_{it}`` per save holds ``state.pt``: every tensor of
``GANTrainState`` (G, D, D's statistics, the frozen D, both Adam states,
the EMA), ``it``, and the state of the ``torch.Generator``, so a resume is
bit-exact. It is written with ``torch.save`` (to a temporary name, then
renamed) and read with ``weights_only=True``.

The readers of weights (``load_generator_state`` for evaluation, inference
and serving, and the loop's warm start from a port checkpoint) take a
checkpoint of any device type: they leave the ``torch.Generator``'s state,
which is of the device type it was saved on, unread. ``load_pack`` is the one way a continuation
pack (``.npz``) enters a state.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
from gan_sr_wind_field_tpu_torch.train.gan import (
    AdamState,
    GANTrainState,
    WindFieldGAN,
)
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)
from gan_sr_wind_field_tpu_torch.utils.torch_import import (
    load_reference_checkpoint,
)

FORMAT_VERSION = 1
STATE_FILE = "state.pt"
_TREES = ("params_G", "params_D", "batch_stats_D", "params_D_frozen",
          "params_G_ema")


def _adam_to_dict(opt: AdamState) -> dict:
    return {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}


def _whole(state) -> None:
    """Raise for a state whose G holds one rank's channels only."""
    if getattr(state, "sharded", None):
        raise ValueError("the state's G is sharded over a model axis: "
                         "gather_state(state, mesh) first")


def save_checkpoint(run_folder: str, state: GANTrainState,
                    keep_last: int = 0) -> str:
    """Write a checkpoint for the state's current iteration; → its folder.

    ``keep_last`` > 0 prunes older ``ckpt_*`` folders down to that many
    (0 keeps all, as the reference does). The state must be whole: on a
    model axis, ``parallel.gather_state`` first, so that a checkpoint is
    the one-process format whatever mesh wrote it."""
    _whole(state)
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


def training_example(cfg, gan: WindFieldGAN) -> GANTrainState:
    """A fresh state of ``gan`` at the training geometry (batch 1, the
    training patch), the example a checkpoint restores into: D's
    classifier depends on the training patch, G on no size."""
    g = cfg.gan_config
    patch = g.slice_size if g.enable_slicing else len(gan.x)
    return gan.init_state(
        0,
        (1, patch // cfg.scale, patch // cfg.scale, g.number_of_z_layers,
         cfg.lr_num_channels),
        (1, patch, patch, g.number_of_z_layers, 3),
    )


def _structure_diffs(name: str, saved, example) -> list:
    """Where tree ``saved`` differs from ``example`` in keys, shapes or
    dtypes: one line per tensor, in the example's order, then the extra
    keys."""
    saved = saved or {}

    def shape(t):
        return "missing" if t is None else (
            f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}")

    return [f"{name}[{k!r}]: saved {shape(saved.get(k))}, expected "
            f"{shape(example.get(k))}"
            for k in [*example, *(k for k in saved if k not in example)]
            if shape(saved.get(k)) != shape(example.get(k))]


def _conv_mode(params_G) -> str:
    """The conv mode of a generator's tensors: a horizontal_3D generator
    holds 6-D kernels."""
    horizontal = any(t.dim() == 6 for t in params_G.values())
    return "horizontal_3D" if horizontal else "3D"


def restore_checkpoint(path: str, example_state: GANTrainState,
                       restore_rng: bool = True) -> GANTrainState:
    """Restore onto the devices of ``example_state`` (a fresh state of the
    same configuration, built at the training geometry: D's classifier
    depends on the training patch).

    With ``restore_rng`` (a resume) the state's ``torch.Generator`` goes on
    from the saved one, which must be of the example's device type, else
    ``ValueError``; without it the example's generator is kept, and a
    checkpoint saved on another device type restores all the same.

    Every tree, and both Adam states, must match the example's keys,
    shapes and dtypes, else ``ValueError`` names the first tensors that
    differ (as the JAX package's restore raises for trees that do not
    match): float32 moments do not restore into a ``bfloat16_sr`` state,
    nor bf16 ones into a float32 state. The
    EMA slot is reconciled across configurations as the JAX package does:
    a checkpoint with an EMA keeps it under a configuration without one,
    and one without an EMA seeds it from the restored G when the
    configuration has one; either EMA has G's structure."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if blob.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"checkpoint {path} has format "
                         f"{blob['format_version']} > {FORMAT_VERSION}")
    ex = example_state
    pairs = [(t, blob[t], getattr(ex, t)) for t in
             ("params_G", "params_D", "batch_stats_D", "params_D_frozen")]
    if blob["params_G_ema"] is not None:
        pairs.append(("params_G_ema", blob["params_G_ema"], ex.params_G))
    pairs += [(f"{o}.{m}", blob[o][m], getattr(getattr(ex, o), m))
              for o in ("opt_state_G", "opt_state_D") for m in ("mu", "nu")]
    bad = [line for name, saved, want in pairs
           for line in _structure_diffs(name, saved, want)]
    if bad:
        more = f"; and {len(bad) - 4} more" if len(bad) > 4 else ""
        hint = ("; the Adam moments' dtype follows optimizer_state_dtype"
                if any(".mu[" in b or ".nu[" in b for b in bad) else "")
        modes = [_conv_mode(t) for t in (blob["params_G"], ex.params_G)]
        if modes[0] != modes[1]:
            hint += (f"; a {modes[0]} checkpoint into a {modes[1]} "
                     "configuration ([GAN] conv_mode)")
        raise ValueError(f"checkpoint {path} does not match the "
                         f"configuration: {'; '.join(bad[:4])}{more}{hint}")

    def like(tree, example):
        if tree is None:
            return None
        dev = next(iter(example.values())).device if example else "cpu"
        return {k: v.to(dev) for k, v in tree.items()}

    def adam(d, example: AdamState) -> AdamState:
        count = torch.tensor(int(d["count"]), dtype=torch.int32,
                             device=example.count.device)
        return AdamState(count, like(d["mu"], example.mu),
                         like(d["nu"], example.nu))

    params_G = like(blob["params_G"], ex.params_G)
    ema = like(blob["params_G_ema"], ex.params_G)
    if ema is None and ex.params_G_ema is not None:
        ema = {k: v.clone() for k, v in params_G.items()}
    rng = ex.rng
    if restore_rng:
        rng = torch.Generator(device=ex.rng.device)
        try:
            rng.set_state(blob["rng_state"])
        except RuntimeError as e:
            raise ValueError(
                f"checkpoint {path}: its random generator state is not one "
                f"of a {ex.rng.device.type} generator (saved on another "
                "device type?); resume on the device type it was saved on, "
                f"or load its weights only ({e})") from e
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


def replace_tree(tree, loaded, what: str):
    """``tree``'s keys, in its order, with the tensors of ``loaded`` on
    ``tree``'s device; ``ValueError`` when the keys differ. Both may be
    empty (the statistics of a D with instance norm and no slicing)."""
    if set(loaded) != set(tree):
        odd = sorted(set(loaded) ^ set(tree))
        raise ValueError(f"{what}: the loaded tensors do not match the "
                         f"configuration's ({odd})")
    return {k: loaded[k].to(v.device) for k, v in tree.items()}


def load_pack(state: GANTrainState, path: str,
              weights_only: bool = False) -> GANTrainState:
    """Load the continuation pack at ``path`` into ``state``; → ``state``.

    The warm start (``loop.py:124-157`` of the JAX package): G, D and D's
    statistics where the pack has them, the EMA from ``Gema`` (else from
    G) where the configuration has an EMA, and ``it``; the Adam moments
    stay as they are (zero in a fresh state). With ``weights_only`` (the
    readers that evaluate or serve, ``eval/test_loop.py:119-131`` of the
    JAX package): G, and the pack's EMA slot or none, whatever the
    configuration."""
    pack = load_continuation(path)
    state.params_G = replace_tree(state.params_G,
                                  params_from_jax(pack["params_G"]), "G")
    ema = pack["params_G_ema"]
    if weights_only:
        state.params_G_ema = None if ema is None else replace_tree(
            state.params_G, params_from_jax(ema), "EMA")
        return state
    if pack["params_D"] is not None:
        state.params_D = replace_tree(
            state.params_D, d_params_from_jax(pack["params_D"]), "D")
    if pack["batch_stats_D"] is not None:
        state.batch_stats_D = replace_tree(
            state.batch_stats_D, d_params_from_jax({}, pack["batch_stats_D"]),
            "D's statistics")
    if state.params_G_ema is not None:
        state.params_G_ema = replace_tree(
            state.params_G_ema, params_from_jax(ema or pack["params_G"]),
            "EMA")
    state.it = int(pack["it"])
    return state


def load_generator_state(cfg, gan: WindFieldGAN, path: str) -> GANTrainState:
    """A state of ``gan`` at the training geometry with the weights at
    ``path``: a continuation pack (``.npz``: its G, and its EMA slot or
    none), a reference ``G_{it}.pth`` (its G, no EMA slot: the imported
    weights are the ones that serve, as JAX ``run.py:275-289`` drops the
    slot) or a port checkpoint folder of any device type (its weights; the
    random generator stays the fresh one)."""
    example = training_example(cfg, gan)
    if path.endswith(".pth"):
        params_G, _, _ = load_reference_checkpoint(gan.G, path)
        example.params_G = replace_tree(example.params_G, params_G, "G")
        example.params_G_ema = None
        return example
    if path.endswith(".npz"):
        return load_pack(example, path, weights_only=True)
    return restore_checkpoint(path, example, restore_rng=False)
