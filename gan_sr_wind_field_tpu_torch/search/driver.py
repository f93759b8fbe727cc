"""Hyperparameter search over the five physics-loss weights.

Counterpart of ``gan_sr_wind_field_tpu/search/driver.py``, the
reference's Ray Tune + Optuna + ASHA sweep (param_search.py:270-424)
without Ray:

- the search space (log-uniform gradient and divergence weights, a
  uniform pixel weight) and the reference's 10 seeded starting points,
  then quasi-random (van der Corput) samples; every constant is JAX's;
- every trial shares ONE ``WindFieldGAN`` (its kernels built once): the
  searched weights are 0-d tensors on the card passed as ``weights=`` to
  ``train_step`` and ``val_step``, so a new trial costs ``init_state``;
- ASHA early stopping at iteration rungs on validation PSNR
  (``search/asha.py``);
- trials run one after another; across cards or hosts, one driver per
  shard (trial i runs on shard i % n_shards), their rung records shared
  through files in the run folder.

Each trial draws from streams of its own seed, ``fixed_seed + trial``: its
initial weights, its host batches (or, with ``device_resident_data``, its
``DeviceBatcher`` stream over volumes uploaded once for all trials), and
its validation draws, one generator per batch seeded from the trial's seed,
the iteration and the batch (``train/loop.py:val_seed``). The JAX package
draws the same distributions from ``jax.random`` keys.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.search.asha import ASHAScheduler
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.loop import val_seed

SEARCH_SPACE = {
    "gradient_xy": ("loguniform", 0.5, 32.0),
    "gradient_z": ("loguniform", 0.25, 16.0),
    "xy_divergence": ("loguniform", 0.25, 16.0),
    "divergence": ("loguniform", 0.25, 16.0),
    "pixel": ("uniform", 0.0, 1.0),
}

# the reference's 10 seeded starting points (param_search.py:305-376)
INITIAL_POINTS: List[Dict[str, float]] = [
    {"gradient_xy": 5.0, "gradient_z": 0.25, "xy_divergence": 1.25,
     "divergence": 0.25, "pixel": 0.15},
    {"gradient_xy": 1.0, "gradient_z": 0.25, "xy_divergence": 1.25,
     "divergence": 1.25, "pixel": 0.15},
    {"gradient_xy": 10.0, "gradient_z": 0.25, "xy_divergence": 2.5,
     "divergence": 0.25, "pixel": 0.25},
    {"gradient_xy": 1.0, "gradient_z": 0.25, "xy_divergence": 2.5,
     "divergence": 2.5, "pixel": 0.25},
    {"gradient_xy": 5.0, "gradient_z": 0.25, "xy_divergence": 1.25,
     "divergence": 2.5, "pixel": 0.2},
    {"gradient_xy": 2.5, "gradient_z": 1.0, "xy_divergence": 0.5,
     "divergence": 1.0, "pixel": 0.15},
    {"gradient_xy": 10.0, "gradient_z": 1.0, "xy_divergence": 0.5,
     "divergence": 1.0, "pixel": 0.2},
    {"gradient_xy": 2.5, "gradient_z": 5.0, "xy_divergence": 0.5,
     "divergence": 1.0, "pixel": 0.2},
    {"gradient_xy": 2.5, "gradient_z": 1.0, "xy_divergence": 2.5,
     "divergence": 1.0, "pixel": 0.2},
    {"gradient_xy": 2.5, "gradient_z": 1.0, "xy_divergence": 0.5,
     "divergence": 5.0, "pixel": 0.2},
]


def _van_der_corput(n: int, base: int) -> float:
    q, denom = 0.0, 1.0
    while n:
        denom *= base
        n, rem = divmod(n, base)
        q += rem / denom
    return q


def sample_point(index: int, seed: int = 0) -> Dict[str, float]:
    """Low-discrepancy quasi-random sample from SEARCH_SPACE."""
    primes = [2, 3, 5, 7, 11]
    rng = np.random.default_rng(seed)
    shifts = rng.random(len(primes))  # Cranley-Patterson rotation
    out = {}
    for dim, (name, (kind, lo, hi)) in enumerate(SEARCH_SPACE.items()):
        u = (_van_der_corput(index + 1, primes[dim]) + shifts[dim]) % 1.0
        if kind == "loguniform":
            out[name] = float(np.exp(np.log(lo) + u * (np.log(hi)
                                                       - np.log(lo))))
        else:
            out[name] = float(lo + u * (hi - lo))
    return out


def trial_point(index: int, seed: int) -> Dict[str, float]:
    """Trial ``index``'s point: the reference's starting points first, then
    ``sample_point`` from ``seed``."""
    if index < len(INITIAL_POINTS):
        return INITIAL_POINTS[index]
    return sample_point(index - len(INITIAL_POINTS), seed=seed)


def point_to_weights(p: Dict[str, float], device=None
                     ) -> Dict[str, torch.Tensor]:
    """A point → the step's loss weights, float32 0-d tensors on
    ``device`` (the CPU by default)."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {"pix": t(p["pixel"]), "gxy": t(p["gradient_xy"]),
            "gz": t(p["gradient_z"]), "div": t(p["divergence"]),
            "xydiv": t(p["xy_divergence"])}


def run_trial(gan: WindFieldGAN, cfg, ds_train, ds_val, point, asha,
              trial_id: int, batch_size: int, status,
              resident: Optional[DeviceBatcher] = None) -> Dict:
    """Train one trial under ASHA; returns its record (the reference's
    stripped trial loop, param_search.py:28-267). ``resident`` is the
    ``DeviceBatcher`` whose uploaded volumes the trials share; it is
    required under ``device_resident_data`` and unused without it."""
    if cfg.device_resident_data and resident is None:
        raise ValueError("device_resident_data: run_trial needs the "
                         "sweep's DeviceBatcher (resident=)")
    weights = point_to_weights(point, gan.device)
    seed = cfg.env.fixed_seed + trial_id
    rng_np = np.random.default_rng(seed)
    probe_lr, probe_hr, _ = ds_train.get(0, rng_np)
    state = gan.init_state(seed, (batch_size,) + probe_lr.shape,
                           (batch_size,) + probe_hr.shape)

    rungs = set(asha.rung_iterations())
    it, best_psnr, last_psnr = 0, -np.inf, 0.0
    stopped = False
    niter = cfg.training.niter
    val_period = cfg.training.val_period
    deterministic = bool(cfg.dataset_val and cfg.dataset_val.deterministic)

    if cfg.device_resident_data:
        # no host-to-device copies in the trial's steps; the volumes are
        # uploaded once, each trial restarts the stream of its own seed
        resident.seed, resident.count = seed, 0

    while it < niter and not stopped:
        for lr_b, hr_b, z_b in (
            resident if cfg.device_resident_data
            else ds_train.batches(batch_size, rng_np, shuffle=True, epochs=1)
        ):
            if it >= niter or stopped:
                break
            it += 1
            state, _ = gan.train_step(state, lr_b, hr_b, z_b, augment=True,
                                      weights=weights)
            if it % val_period == 0 or it in rungs:
                psnrs = []
                # deterministic track: identical patch offsets every sweep,
                # so ASHA compares trials on a stable metric
                vrng = (np.random.default_rng(cfg.env.fixed_seed)
                        if deterministic else rng_np)
                for bi, (vlr, vhr, vz) in enumerate(
                    ds_val.batches(batch_size, vrng, shuffle=False,
                                   drop_remainder=False)
                ):
                    gen = torch.Generator(device=gan.device).manual_seed(
                        val_seed(seed, it, bi))
                    m, _ = gan.val_step(state, vlr, vhr, vz, generator=gen,
                                        weights=weights)
                    psnrs.append(float(m["val_PSNR"]))
                last_psnr = float(np.mean(psnrs)) if psnrs else -np.inf
                best_psnr = max(best_psnr, last_psnr)
                if it in rungs and not asha.report(it, last_psnr):
                    status.info(f"trial {trial_id}: ASHA stop at it {it} "
                                f"(PSNR {last_psnr:.3f})")
                    stopped = True

    return {"trial": trial_id, "point": point, "it": it,
            "PSNR": last_psnr, "best_PSNR": best_psnr,
            "stopped_early": stopped}


def param_search(cfg, ds_train, ds_val, x, y, num_samples: int = 250,
                 shard_index: int = 0, num_shards: int = 1,
                 out_path: Optional[str] = None, grace_period: int = 1200,
                 reduction_factor: int = 3, device=None) -> List[Dict]:
    """Run the sweep on ``device`` (the card unless the caller asks for the
    CPU); appends each trial's record to ``param_search.jsonl`` and writes
    the best one to ``param_search_best.json`` in the run folder, as the
    JAX package does. Returns the records.

    ``grace_period``/``reduction_factor`` default to the reference's ASHA
    settings (param_search.py:298-303); a sweep with a smaller budget
    scales the rungs down with them."""
    status = logging.getLogger("status")
    if not (cfg.dataset_val and cfg.dataset_val.deterministic):
        status.warning(
            "param search on the quirk-parity val track: random val "
            "augmentation makes PSNR swing ~10 dB between sweeps; set "
            "[DATASETVAL] deterministic=true for stable ASHA decisions")
    gan = WindFieldGAN(cfg, x, y, device=resolve_device(device))
    batch_size = cfg.dataset_train.batch_size if cfg.dataset_train else 8
    resident = (DeviceBatcher(ds_train, batch_size, gan.device)
                if cfg.device_resident_data else None)

    run_folder = cfg.env.this_runs_folder or "."
    # sharded sweeps share rung state through per-shard JSONLs in the
    # (shared) run folder, so promotion decisions see the whole population
    # as the reference's single Ray head does (param_search.py:298-303)
    asha = ASHAScheduler(
        max_t=cfg.training.niter, grace_period=grace_period,
        reduction_factor=reduction_factor,
        share_dir=run_folder if num_shards > 1 else None,
        shard_index=shard_index)
    out_path = out_path or os.path.join(run_folder, "param_search.jsonl")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    results = []
    with open(out_path, "a") as f:
        for i in range(num_samples):
            if i % num_shards != shard_index:
                continue
            point = trial_point(i, cfg.env.fixed_seed)
            status.info(f"trial {i}: {point}")
            rec = run_trial(gan, cfg, ds_train, ds_val, point, asha, i,
                            batch_size, status, resident)
            results.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()

    best = max(results, key=lambda r: r["best_PSNR"]) if results else None
    if best:
        status.info(f"best trial: {best}")
        with open(os.path.join(run_folder, "param_search_best.json"),
                  "w") as f:
            json.dump(best, f, indent=2)
    return results
