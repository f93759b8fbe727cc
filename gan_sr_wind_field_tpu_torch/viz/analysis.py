"""Offline run analysis (the port's copy of
``gan_sr_wind_field_tpu/viz/analysis.py``): the reference's
TensorBoard-log analysis (plot_data.py:341-767, via tbparse there) and
feature-map extraction (plot_data.py:770-793).

The metrics come from the ``events.jsonl`` stream every run writes
(``utils/tb.py``; the scalars also go to TensorBoard when it imports).
Matplotlib is imported inside the plotting functions (Agg).
``get_feature_maps`` takes the generator's activations with forward hooks,
where the JAX package uses flax's ``capture_intermediates``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from gan_sr_wind_field_tpu_torch.utils.jax_params import _INDEXED_BACK


def read_events(log_dir: str) -> Dict[str, Dict[str, List]]:
    """events.jsonl → {tag/key: {'step': [...], 'value': [...]}}."""
    out: Dict[str, Dict[str, List]] = defaultdict(
        lambda: {"step": [], "value": []}
    )
    path = os.path.join(log_dir, "events.jsonl")
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec["values"].items():
                key = f"{rec['tag']}/{k}"
                out[key]["step"].append(rec["step"])
                out[key]["value"].append(v)
    return dict(out)


def plot_metric_runs(
    run_dirs: Sequence[str],
    metric: str = "metrics/PSNR/val_PSNR",
    baseline_metric: Optional[str] = "metrics/PSNR/Trilinear_PSNR",
    labels: Optional[Sequence[str]] = None,
    ylim=None,
    out_path: Optional[str] = None,
):
    """Training-curve comparison across runs with the trilinear baseline as
    a dashed reference (the signature plot of the thesis analysis,
    plot_data.py:536-767)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    baseline_drawn = False
    for i, run in enumerate(run_dirs):
        ev = read_events(run)
        if metric not in ev:
            continue
        label = labels[i] if labels else os.path.basename(run.rstrip("/"))
        ax.plot(ev[metric]["step"], ev[metric]["value"], label=label)
        if baseline_metric and not baseline_drawn and baseline_metric in ev:
            ax.plot(
                ev[baseline_metric]["step"], ev[baseline_metric]["value"],
                "k--", label="trilinear",
            )
            baseline_drawn = True
    ax.set_xlabel("iteration")
    ax.set_ylabel(metric.rsplit("/", 1)[-1])
    if ylim:
        ax.set_ylim(*ylim)
    ax.legend()
    ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
    return fig


def exp_comparison_plot(
    run_dirs: Sequence[str],
    highlight: Optional[Sequence[str]] = None,
    metric: str = "metrics/PSNR/val_PSNR",
    loss_metric: str = "G_loss/validation/total",
    baseline_metric: Optional[str] = "metrics/PSNR/Trilinear_PSNR",
    band=(33.0, 41.0),
    loss_ylim=None,
    labels: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
):
    """The thesis experiment-comparison figure (plot_data.py:536-767):
    two stacked panels — validation PSNR clamped to the reference's
    33-41 dB result band, and total validation loss — with non-highlighted
    runs drawn grey in the background, highlighted runs coloured on top,
    and the trilinear baseline dashed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    highlight = set(highlight) if highlight else set(run_dirs)
    fig, ax = plt.subplots(2, 1, sharex=True, figsize=(10, 7))
    ax[0].set_ylim(*band)
    ax[0].set_ylabel("PSNR")
    ax[1].set_ylabel("Total validation loss")
    ax[1].set_xlabel("Training iteration")
    if loss_ylim:
        ax[1].set_ylim(*loss_ylim)

    events = {run: read_events(run) for run in run_dirs}
    # background pass: every non-highlighted run, grey
    for run in run_dirs:
        if run in highlight:
            continue
        ev = events[run]
        if metric in ev:
            ax[0].plot(ev[metric]["step"], ev[metric]["value"], color="#CCCCCC")
        if loss_metric in ev:
            ax[1].plot(ev[loss_metric]["step"], ev[loss_metric]["value"],
                       color="#CCCCCC")
    # foreground pass: highlighted runs, coloured + labelled. labels map
    # one-to-one onto the HIGHLIGHTED runs in run_dirs order (only they
    # are labelled), not onto run_dirs
    baseline_drawn = False
    n_drawn = 0
    for run in run_dirs:
        if run not in highlight:
            continue
        ev = events[run]
        label = (labels[n_drawn] if labels and n_drawn < len(labels)
                 else os.path.basename(run.rstrip("/")))
        n_drawn += 1
        if metric in ev:
            ax[0].plot(ev[metric]["step"], ev[metric]["value"], label=label)
        if loss_metric in ev:
            ax[1].plot(ev[loss_metric]["step"], ev[loss_metric]["value"])
        if baseline_metric and not baseline_drawn and baseline_metric in ev:
            ax[0].plot(ev[baseline_metric]["step"],
                       ev[baseline_metric]["value"], "k--",
                       label="trilinear")
            baseline_drawn = True
    ax[0].legend(fontsize=8)
    for a in ax:
        a.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
    return fig


def decomposed_val_loss_plot(
    run_dir: str,
    losses: Sequence[str] = (
        "xy_gradient", "xy_divergence", "z_gradient", "divergence",
        "pix", "adversarial",
    ),
    ylim=(0.0, 0.06),
    grad_norm: bool = False,
    out_path: Optional[str] = None,
):
    """Per-term validation-loss curves for one run — the thesis
    "decomposed validation loss" figure (plot_data.py:485-519
    create_best_exp25_plot), plus optionally the training grad-norm track
    (plot_data.py:521-533 create_norm_plot) as a second panel when the run
    logged ``metrics/grad/G_grad_norm`` (use_grad_clipping runs)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ev = read_events(run_dir)
    norm_key = "metrics/grad/G_grad_norm"
    want_norm = grad_norm and norm_key in ev
    fig, axes = plt.subplots(
        2 if want_norm else 1, 1, sharex=True,
        figsize=(10, 7 if want_norm else 4), squeeze=False,
    )
    ax = axes[0][0]
    for loss in losses:
        key = f"G_loss/validation/{loss}"
        if key in ev:
            ax.plot(ev[key]["step"], ev[key]["value"], label=loss)
    ax.set_ylabel("Validation loss")
    if ylim:
        ax.set_ylim(*ylim)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    if want_norm:
        axn = axes[1][0]
        # grad norm is only computed on G steps; drop the D-step zeros
        steps = np.asarray(ev[norm_key]["step"])
        vals = np.asarray(ev[norm_key]["value"])
        keep = vals > 0.0
        axn.plot(steps[keep], vals[keep])
        axn.set_ylabel("G grad norm")
        axn.grid(alpha=0.3)
        axn.set_xlabel("Training iteration")
    else:
        ax.set_xlabel("Training iteration")
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
    return fig


def _main(argv=None):
    """CLI: regenerate the thesis band plot from run folders.

    python -m gan_sr_wind_field_tpu_torch.viz.analysis RUN_TB_DIR... --out fig.png
    """
    import argparse

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("runs", nargs="+",
                   help="run tb folders containing events.jsonl")
    p.add_argument("--out", default="exp_comparison.png")
    p.add_argument("--highlight", nargs="*", default=None)
    p.add_argument("--band", nargs=2, type=float, default=(33.0, 41.0))
    args = p.parse_args(argv)
    exp_comparison_plot(
        args.runs, highlight=args.highlight, band=tuple(args.band),
        out_path=args.out,
    )
    print(f"wrote {args.out}")


def _flax_name(qualified: str) -> str:
    """A port module's qualified name as the JAX package's module path:
    ``rrdbs.0.rdbs.1`` → ``RRDB0/RDB1``, ``...lff`` → ``.../LFF``."""
    parts = qualified.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] in _INDEXED_BACK and i + 1 < len(parts):
            out.append(f"{_INDEXED_BACK[parts[i]]}{parts[i + 1]}")
            i += 2
        else:
            out.append("LFF" if parts[i] == "lff" else parts[i])
            i += 1
    return "/".join(out)


def get_feature_maps(gan, params_G, lr, z, layer_filter: str = "RRDB0"):
    """Intermediate generator activations, eval mode, from forward hooks
    (the reference slices its nn.Sequential, plot_data.py:770-793; the JAX
    package captures flax intermediates). ``gan`` is a port
    ``WindFieldGAN`` (anything with its generator as ``G``), ``params_G``
    a state's G, lr and z arrays or tensors; every module whose own
    name in the JAX package's module path contains ``layer_filter`` is
    captured (the default, ``RRDB0``, is the first RRDB). Returns
    {path: (output,)}, the path as the JAX package's (``RRDB0``,
    ``RRDB0/RDB1``), the outputs detached."""
    import torch
    from torch.func import functional_call

    G = gan.G
    feats, hooks = {}, []

    def keep(path):
        def hook(module, args, out):
            feats[path] = feats.get(path, ()) + (out.detach(),)
        return hook

    for name, mod in G.named_modules():
        path = _flax_name(name)
        if name and layer_filter in path.rsplit("/", 1)[-1]:
            hooks.append(mod.register_forward_hook(keep(path)))
    try:
        with torch.no_grad():
            dev = next(iter(params_G.values())).device
            functional_call(G, params_G, tuple(
                torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (lr, z)))
    finally:
        for h in hooks:
            h.remove()
    return feats


def patch_offset_distribution(n: int = 100000, full: int = 128,
                              patch: int = 64, seed: int = 0):
    """Beta(0.25,0.25) corner-biased offsets vs uniform — the demo histogram
    from plot_data.py:884-929."""
    rng = np.random.default_rng(seed)
    beta = np.round(rng.beta(0.25, 0.25, size=n) * (full - patch)).astype(int)
    uniform = rng.integers(0, full - patch + 1, size=n)
    return beta, uniform


if __name__ == "__main__":
    _main()
