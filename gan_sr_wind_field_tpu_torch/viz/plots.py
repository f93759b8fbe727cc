"""Validation and inspection figures (the port's copy of
``gan_sr_wind_field_tpu/viz/plots.py``).

Matplotlib counterparts of the reference's TensorBoard figures
(train.py:383-555: the 2×2 LR/HR/SR/TL comparison and the 2×3 error
panels), and the offline 2D report from a test-field pickle. Numpy arrays
in, figures out; matplotlib is imported inside each function (Agg), so the
module imports without it. mayavi's 3D scenes are out of scope on a
headless host; the pickled field dumps keep the reference's schema.
"""

from __future__ import annotations

import os

import numpy as np


def create_comparison_figure(z_index, lr2d, hr2d, sr2d, tl2d):
    """2×2 panel of one z-slice of a wind component: LR/HR/TL/SR."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(8, 7))
    vmin = float(np.min(hr2d[:, :, z_index]))
    vmax = float(np.max(hr2d[:, :, z_index]))
    panels = [
        (axes[0, 0], lr2d, "LR"),
        (axes[0, 1], hr2d, "HR"),
        (axes[1, 0], tl2d, "TL"),
        (axes[1, 1], sr2d, "SR"),
    ]
    for ax, arr, title in panels:
        zi = min(z_index, arr.shape[2] - 1)
        ax.pcolormesh(arr[:, :, zi], vmin=vmin, vmax=vmax, cmap="viridis")
        ax.set_title(title)
    fig.subplots_adjust(hspace=0.3)
    sm = plt.cm.ScalarMappable(cmap="viridis")
    sm.set_clim(vmin=vmin, vmax=vmax)
    fig.colorbar(sm, ax=axes)
    return fig


def create_error_figure(
    z_index, hr2d, sr2d, tl2d, sr_err, tl_err, sr_rel=None, tl_rel=None
):
    """2×3 panel: signed error / field / absolute error for SR and TL.

    When ``sr_rel``/``tl_rel`` are given, the centre-panel titles carry the
    relative error like the reference's offline figures
    (plot_data.py:227-229,260-262: "avg error: X m/s (Y% of average)")."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(12, 6), sharex=True, sharey=True)
    hs = hr2d[:, :, z_index]
    for row, (field, err_val, rel, name) in enumerate(
        [
            (sr2d[:, :, z_index], sr_err, sr_rel, "SR"),
            (tl2d[:, :, z_index], tl_err, tl_rel, "TL"),
        ]
    ):
        axes[row, 0].pcolormesh(field - hs, cmap="coolwarm")
        axes[row, 0].set_title(f"Error {name}-HR (m/s)")
        axes[row, 1].pcolormesh(field, cmap="viridis")
        title = f"{name}, avg error: {round(float(err_val), 3)} m/s"
        if rel is not None:
            title += f" ({round(100 * float(rel), 1)}% of average)"
        axes[row, 1].set_title(title)
        axes[row, 2].pcolormesh(np.abs(hs - field), cmap="jet")
        axes[row, 2].set_title(f"{name} Absolute Error (m/s)")
    fig.subplots_adjust(hspace=0.2)
    return fig


_COMPONENT_INDEX = {"u": 0, "v": 1, "w": 2}


def create_2d_report(
    fields_path,
    z_levels=(0, 5),
    components=("u", "w"),
    out_dir="figures",
    scale=4,
):
    """Regenerate the reference's offline 2D publication figures from one
    test-field pickle (plot_data.py:988-1120 ``create_2D_plots``): per wind
    component and z-level, a 2×2 LR/HR/TL/SR comparison panel and a 2×3
    error panel with per-slice L1 / relative-L1 in the titles, saved with
    the reference filename scheme ``{comp}_{z}_scale{scale}[_error].png``.

    ``fields_path`` is a ``fields/test_fields_*.pkl`` written by the eval
    loop (channel-first (3,X,Y,Z) HR/SR/TL/LR arrays). Returns the list of
    written paths.
    """
    import pickle

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(fields_path, "rb") as f:
        fields = pickle.load(f)
    for key in ("HR", "SR", "TL", "LR"):
        if key not in fields:
            raise KeyError(
                f"{fields_path} lacks '{key}' — create_2d_report needs a "
                "full test-mode dump (run.py --test), not a --use SR-only one"
            )
    nz = fields["HR"].shape[3]
    bad = [z for z in z_levels if not 0 <= z < nz]
    if bad:
        raise ValueError(f"z levels {bad} out of range for {nz} z layers")
    written = []
    os.makedirs(out_dir, exist_ok=True)
    for comp in components:
        ci = _COMPONENT_INDEX[comp]
        hr, sr = fields["HR"][ci], fields["SR"][ci]
        tl, lr = fields["TL"][ci], fields["LR"][ci]
        for z in z_levels:
            hs = hr[:, :, z]
            denom = float(np.mean(np.abs(hs)))
            sr_err = float(np.mean(np.abs(hs - sr[:, :, z])))
            tl_err = float(np.mean(np.abs(hs - tl[:, :, z])))
            fig_cmp = create_comparison_figure(z, lr, hr, sr, tl)
            fig_err = create_error_figure(
                z, hr, sr, tl, sr_err, tl_err,
                sr_rel=sr_err / denom if denom else None,
                tl_rel=tl_err / denom if denom else None,
            )
            for fig, suffix in ((fig_cmp, ""), (fig_err, "_error")):
                path = os.path.join(
                    out_dir, f"{comp}_{z}_scale{scale}{suffix}.png"
                )
                fig.savefig(path, bbox_inches="tight", dpi=fig.dpi)
                plt.close(fig)
                written.append(path)
    return written


def _main(argv=None):
    """CLI: offline 2D figures from a test-field pickle.

    python -m gan_sr_wind_field_tpu_torch.viz.plots RUN/fields/test_fields_X.pkl \
        --z 0 5 --components u w --out figures --scale 4
    """
    import argparse

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("fields", help="fields/test_fields_*.pkl from --test")
    p.add_argument("--z", nargs="+", type=int, default=[0, 5])
    p.add_argument("--components", nargs="+", default=["u", "w"],
                   choices=sorted(_COMPONENT_INDEX))
    p.add_argument("--out", default="figures")
    p.add_argument("--scale", type=int, default=4)
    args = p.parse_args(argv)
    written = create_2d_report(
        args.fields, z_levels=tuple(args.z),
        components=tuple(args.components), out_dir=args.out,
        scale=args.scale,
    )
    for path in written:
        print(f"wrote {path}")


if __name__ == "__main__":
    _main()
