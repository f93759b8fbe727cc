"""PyTorch port: the ``viz`` package, the loop's validation figures and the
packages' public names, on the CPU.

Modelled on ``tests/test_viz_and_utils.py`` and ``tests/test_field3d.py``
with the port's modules, plus: the modules import without matplotlib,
``get_feature_maps`` (forward hooks) against JAX's captured intermediates,
the loop's two figures go to a writer with a figure sink only, and each
name the JAX package's ``ops``, ``models`` and ``train`` export has its
port counterpart, held against JAX on one input.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_tiny import make_batch, tiny_cfg
from gan_sr_wind_field_tpu_torch.utils.tb import MetricsWriter
from gan_sr_wind_field_tpu_torch.viz.analysis import (
    _main as analysis_main,
)
from gan_sr_wind_field_tpu_torch.viz.analysis import (
    decomposed_val_loss_plot,
    exp_comparison_plot,
    get_feature_maps,
    patch_offset_distribution,
    plot_metric_runs,
    read_events,
)
from gan_sr_wind_field_tpu_torch.viz.field3d import (
    export_vtk_structured_grid,
    plot_field_3d,
    plot_scalar_3d,
)
from gan_sr_wind_field_tpu_torch.viz.plots import _main as plots_main
from gan_sr_wind_field_tpu_torch.viz.plots import (
    create_2d_report,
    create_comparison_figure,
    create_error_figure,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(*figs):
    import matplotlib.pyplot as plt

    for fig in figs:
        plt.close(fig)


def test_viz_modules_import_without_matplotlib():
    """No module of the port's viz package imports matplotlib at import
    time (the card's machine has none); JAX viz/field3d.py does."""
    code = ("import sys\n"
            "import gan_sr_wind_field_tpu_torch.viz.analysis\n"
            "import gan_sr_wind_field_tpu_torch.viz.field3d\n"
            "import gan_sr_wind_field_tpu_torch.viz.plots\n"
            "import gan_sr_wind_field_tpu_torch.train.loop\n"
            "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _write_events(log_dir):
    w = MetricsWriter(str(log_dir), use_tensorboard=False)
    for it in (2, 4, 6):
        w.add_scalars("metrics/PSNR",
                      {"val_PSNR": 30 + it, "Trilinear_PSNR": 33.0}, it)
        w.add_scalars("G_loss/validation",
                      {"total": 0.1 / it, "pix": 0.05 / it,
                       "xy_gradient": 0.02 / it}, it)
        w.add_scalars("metrics/grad",
                      {"G_grad_norm": 3.0 / it if it % 4 == 2 else 0.0}, it)
    w.close()


def test_read_events_and_run_plots(tmp_path):
    runs = []
    for name in ("runA", "runB"):
        _write_events(tmp_path / name)
        runs.append(str(tmp_path / name))
    ev = read_events(runs[0])
    assert ev["metrics/PSNR/val_PSNR"]["step"] == [2, 4, 6]
    assert ev["metrics/PSNR/val_PSNR"]["value"][-1] == 36.0
    out = tmp_path / "plot.png"
    fig = plot_metric_runs(runs, out_path=str(out))
    assert out.exists() and fig.axes
    band = tmp_path / "band.png"
    analysis_main(runs + ["--out", str(band), "--highlight", runs[0]])
    assert band.stat().st_size > 0
    fig2 = exp_comparison_plot(runs, highlight=[runs[1]], labels=["best"],
                               band=(20, 40))
    texts = [t.get_text() for t in fig2.axes[0].get_legend().get_texts()]
    assert texts == ["best", "trilinear"]
    dec = tmp_path / "decomposed.png"
    fig3 = decomposed_val_loss_plot(runs[0], grad_norm=True,
                                    out_path=str(dec))
    assert dec.exists() and len(fig3.axes) == 2
    fig4 = decomposed_val_loss_plot(runs[0])
    assert len(fig4.axes) == 1
    _close(fig, fig2, fig3, fig4)


def test_patch_offset_distribution_corner_biased():
    beta, uniform = patch_offset_distribution(n=20000, full=128, patch=64)
    assert (np.mean((beta < 8) | (beta > 56))
            > 2 * np.mean((uniform < 8) | (uniform > 56)))
    assert beta.min() >= 0 and beta.max() <= 64


def _write_fields_pickle(path, rng, nz=4):
    hr = rng.standard_normal((3, 16, 16, nz)).astype(np.float32)
    fields = {"HR": hr, "SR": hr * 0.9, "TL": hr * 1.1, "LR": hr[:, ::4, ::4],
              "Z": np.abs(hr[0]) * 100.0}
    with open(path, "wb") as f:
        pickle.dump(fields, f)


def test_figures_and_2d_report(tmp_path, rng):
    hr = rng.standard_normal((16, 16, 4)).astype(np.float32)
    fig1 = create_comparison_figure(1, hr[::4, ::4], hr, hr * 0.9, hr * 1.1)
    fig2 = create_error_figure(1, hr, hr * 0.9, hr * 1.1, 0.1, 0.2)
    assert fig1.axes and fig2.axes
    _close(fig1, fig2)
    pkl = tmp_path / "test_fields_demo.pkl"
    _write_fields_pickle(str(pkl), rng)
    written = create_2d_report(str(pkl), z_levels=(0, 2),
                               components=("u", "w"),
                               out_dir=str(tmp_path / "figures"), scale=4)
    assert {os.path.basename(p) for p in written} == {
        f"{c}_{z}_scale4{s}.png" for c in ("u", "w") for z in (0, 2)
        for s in ("", "_error")}
    out = tmp_path / "figs"
    plots_main([str(pkl), "--z", "1", "--components", "v", "--out",
                str(out), "--scale", "8"])
    assert (out / "v_1_scale8.png").exists()
    assert (out / "v_1_scale8_error.png").exists()
    use_pkl = tmp_path / "use_fields.pkl"
    with open(use_pkl, "wb") as f:
        pickle.dump({"LR": np.zeros((3, 4, 4, 2)),
                     "SR": np.zeros((3, 16, 16, 2))}, f)
    with pytest.raises(KeyError, match="full test-mode dump"):
        create_2d_report(str(use_pkl), out_dir=str(out))


def _field(rng, nx=8, ny=8, nz=4):
    x = np.arange(nx, dtype=np.float32) * 150.0
    y = np.arange(ny, dtype=np.float32) * 150.0
    terrain = 50.0 * rng.random((nx, ny)).astype(np.float32)
    z = terrain[:, :, None] + np.cumsum(
        np.full((nx, ny, nz), 12.0, np.float32), axis=-1)
    uvw = rng.standard_normal((nx, ny, nz, 3)).astype(np.float32)
    return x, y, z, terrain, uvw


def test_field3d_figures_and_vtk_export(tmp_path, rng):
    """The 3D figures, and the VTK file read back: x fastest, z slowest,
    the vectors in point order (``tests/test_field3d.py``)."""
    x, y, z, terrain, uvw = _field(rng)
    fig1 = plot_field_3d(x, y, z, uvw, terrain=terrain, stride=2)
    fig2 = plot_scalar_3d(x, y, z, np.linalg.norm(uvw, axis=-1))
    assert fig1.axes and fig2.axes
    _close(fig1, fig2)
    x, y, z, _, uvw = _field(rng, 4, 3, 2)
    path = export_vtk_structured_grid(
        str(tmp_path / "field"), x, y, z, vectors={"wind": uvw},
        scalars={"speed": np.linalg.norm(uvw, axis=-1)})
    text = open(path).read()
    for line in ("DATASET STRUCTURED_GRID", "DIMENSIONS 4 3 2",
                 "VECTORS wind float", "SCALARS speed float 1"):
        assert line in text
    lines = text.splitlines()
    i0 = next(i for i, ln in enumerate(lines) if ln.startswith("POINTS")) + 1
    pts = np.loadtxt(lines[i0:i0 + 24])
    np.testing.assert_allclose(pts[:4, 0], x)
    np.testing.assert_allclose(pts[-1, 2], z[-1, -1, -1], rtol=1e-5)
    iv = next(i for i, ln in enumerate(lines)
              if ln.startswith("VECTORS")) + 1
    vec = np.loadtxt(lines[iv:iv + 24])
    np.testing.assert_allclose(vec[1], uvw[1, 0, 0], rtol=1e-5, atol=1e-6)


def test_get_feature_maps_matches_jax():
    """Forward hooks on the modules whose JAX name holds the filter (RRDB0;
    RDB1, which also matches RRDB1, as in JAX) give JAX's
    capture_intermediates outputs within 1e-5."""
    from types import SimpleNamespace

    from gan_sr_wind_field_tpu.models import Generator3D as JaxG
    from gan_sr_wind_field_tpu.viz.analysis import (
        get_feature_maps as jax_get_feature_maps,
    )
    from gan_sr_wind_field_tpu_torch.models import Generator3D
    from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax

    tiny = dict(in_channels=4, num_features=8, num_rrdb=2, num_rdb_convs=3,
                rdb_growth_channels=4, upscale=4, hr_kern_size=3,
                terrain_features=4)
    lr, _, z = make_batch(0)
    jg = JaxG(**tiny)
    params = jax.tree.map(np.asarray, jg.init(jax.random.key(0), lr, z,
                                              train=False)["params"])
    G = Generator3D(**tiny)
    sd = params_from_jax(params)
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if k == "__call__":
                yield prefix, v
            else:
                yield from flat(v, f"{prefix}/{k}" if prefix else k)

    for flt, paths in (("RRDB0", {"RRDB0"}),
                       ("RDB1", {"RRDB1", "RRDB0/RDB1", "RRDB1/RDB1"})):
        want = dict(flat(jax_get_feature_maps(
            SimpleNamespace(G=jg), params, lr, z, layer_filter=flt)))
        got = get_feature_maps(SimpleNamespace(G=G), sd, lr, z,
                               layer_filter=flt)
        assert set(got) == set(want) == paths
        for path in paths:
            w = np.asarray(want[path][0])
            (g,) = got[path]
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


class _Recorder:
    """A writer with a figure sink that keeps the figures' tags."""

    has_figure_sink = True

    def __init__(self):
        self.figures = []

    def add_scalars(self, tag, values, step):
        pass

    def add_figure(self, tag, figure, step):
        self.figures.append(tag)
        _close(figure)


def test_loop_validation_figures_need_a_figure_sink(tmp_path):
    """run_validation adds JAX's two figures (train/loop.py:555-569) to a
    writer with a figure sink, and none without one or without
    use_tensorboard_logger."""
    from gan_sr_wind_field_tpu_torch.data import preprocess
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    from gan_sr_wind_field_tpu_torch.train.loop import run_validation

    cfg = tiny_cfg(True)
    cfg.env.data_root = str(tmp_path / "data")
    cfg.env.root_path = str(tmp_path)
    _, _, ds_val, x, y = preprocess(cfg, synthetic=True, synthetic_hours=6,
                                    synthetic_size=32)
    gan = WindFieldGAN(cfg, x, y, device="cpu")
    state = gan.init_state(0, (1, 4, 4, 4, 4), (1, 16, 16, 4, 3))
    os.makedirs(tmp_path / "images")
    for use_tb, sink in ((True, True), (True, False), (False, True)):
        cfg.use_tensorboard_logger = use_tb
        tb = _Recorder()
        tb.has_figure_sink = sink
        run_validation(cfg, gan, state, ds_val, tb, str(tmp_path), 4)
        assert tb.figures == ([
            "im/4/wind_fields/u_field_z_index3",
            "im/4/Error/u_field_z_index3"] if use_tb and sink else [])
    assert not MetricsWriter(str(tmp_path / "tb"),
                             use_tensorboard=False).has_figure_sink


def test_public_names_match_jax():
    """Every name of JAX's ops, models and train packages has its port
    counterpart (``kaiming_scaled`` is the in-place ``kaiming_scaled_``);
    the ops and the three new metrics agree with JAX on one input."""
    import gan_sr_wind_field_tpu.models as jmodels
    import gan_sr_wind_field_tpu.ops as jops
    import gan_sr_wind_field_tpu.train as jtrain
    from gan_sr_wind_field_tpu.ops import metrics as jmetrics

    import gan_sr_wind_field_tpu_torch.models as models
    import gan_sr_wind_field_tpu_torch.ops as ops
    import gan_sr_wind_field_tpu_torch.train as train
    from gan_sr_wind_field_tpu_torch.ops import metrics

    assert ops.__all__ == jops.__all__
    assert train.__all__ == jtrain.__all__
    assert sorted(models.__all__) == sorted(
        "kaiming_scaled_" if n == "kaiming_scaled" else n
        for n in jmodels.__all__)
    lr, hr, z = make_batch(4)
    sr = (hr * 0.9 + 0.01).astype(np.float32)
    t = torch.from_numpy
    coords = np.arange(16, dtype=np.float32) * 150
    pairs = [
        (ops.psnr(t(hr), t(sr)), jops.psnr(hr, sr)),
        (ops.decimate_xy(t(hr), 4), jops.decimate_xy(hr, 4)),
        (ops.upsample_nearest_xy(t(lr), 2), jops.upsample_nearest_xy(lr, 2)),
        (ops.upsample_trilinear_xy(t(lr), 4),
         jops.upsample_trilinear_xy(lr, 4)),
        (ops.wind_field_gradient(t(hr), t(coords), t(coords), t(z)),
         jops.wind_field_gradient(hr, coords, coords, z)),
        (metrics.mean_absolute_error(t(hr), t(sr)),
         jmetrics.mean_absolute_error(hr, sr)),
        (metrics.wind_vector_error(t(hr), t(sr), 12.5),
         jmetrics.wind_vector_error(hr, sr, 12.5)),
        (metrics.relative_wind_error(t(hr), t(sr)),
         jmetrics.relative_wind_error(hr, sr)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    assert models.Generator3D.__name__ == jmodels.Generator3D.__name__
    assert train.WindFieldGAN.__name__ == jtrain.WindFieldGAN.__name__
