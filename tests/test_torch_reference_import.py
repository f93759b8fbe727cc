"""PyTorch port: reference ``G_{it}.pth`` / ``D_{it}.pth`` checkpoints
(``utils/torch_import.py``) against the JAX package's import, on the CPU in
float32 at the tiny geometry of ``tests/_torch_tiny.py``.

- seeded reference-layout state dicts (the JAX package's export names the
  layout) for G at 4x, 8x and 16x and for D with and without
  ``enable_slicing``: the port's import gives exactly the tensors of the
  JAX import composed with ``utils/jax_params.py``, the forwards agree
  within 1e-5 of the output's largest entry, and export∘import is the
  identity key for key;
- a ``.pth`` the JAX package writes is read by the port, and the reverse;
  a missing key or a wrong shape raises naming the key;
- every reader: the loop's warm start (G and D files, the EMA seeded from
  G, a pack's G with a reference D), ``WindFieldSR.from_checkpoint``
  against the JAX package's, ``--test`` against JAX's ``run_test`` on the
  same file, ``--use`` and ``eval.interp``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, tiny_cfg
from gan_sr_wind_field_tpu.eval import test_loop as jax_tl
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxWindFieldSR
from gan_sr_wind_field_tpu.models import Discriminator3D as FlaxD
from gan_sr_wind_field_tpu.models import Generator3D as FlaxG
from gan_sr_wind_field_tpu.train.continuation import save_continuation
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.utils import torch_import as jti
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.eval import test_loop as tl
from gan_sr_wind_field_tpu_torch.eval.interp import (
    blend_params,
    interpolated_sr,
)
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.models.discriminator import Discriminator3D
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D
from gan_sr_wind_field_tpu_torch.utils import torch_import as ti
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
    params_to_jax,
)
from test_torch_loop import _train, loop_cfg
from test_torch_test_loop import _cfg, _data, _same_csv

G_TINY = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=1,
              hr_kern_size=3, num_rdb_convs=2, rdb_growth_channels=4,
              terrain_features=4)
FWD_TOL = 1e-5  # of the output's largest entry, float32


def _flax_g(scale):
    return FlaxG(upscale=scale, dropout_probability=0.0,
                 split_hr_concat=True, remat=False, **G_TINY)


def _g_inputs(scale, seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    z = rng.standard_normal((2, 4 * scale, 4 * scale, 4, 1)).astype(
        np.float32)
    return lr, z


def _flax_g_params(scale, seed=0):
    lr, z = _g_inputs(scale)
    return jax.tree.map(np.asarray, _flax_g(scale).init(
        jax.random.key(seed), jnp.asarray(lr), jnp.asarray(z),
        train=False)["params"])


def _seeded(sd, seed, positive=()):
    """``sd``'s keys and shapes with seeded values (0.1 · normal; the keys
    in ``positive`` 0.5 + uniform, as running variances are)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        shape = tuple(np.shape(v))
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
        elif any(k.endswith(p) for p in positive):
            out[k] = torch.from_numpy(
                (0.5 + rng.random(shape)).astype(np.float32))
        else:
            out[k] = torch.from_numpy(
                (0.1 * rng.standard_normal(shape)).astype(np.float32))
    return out


def _ref_g_sd(scale, seed=0):
    """A reference-layout G state dict: the JAX package's export names its
    keys and shapes, the values are seeded."""
    return _seeded(jti.export_generator_state_dict(_flax_g_params(scale),
                                                   _flax_g(scale)), seed)


def _port_g(scale):
    return Generator3D(upscale=scale, **G_TINY)


def _close(got, want, tol=FWD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize("scale", [4, 8, 16])
def test_generator_import_matches_jax(scale):
    sd = _ref_g_sd(scale, seed=scale)
    G = _port_g(scale)
    got = ti.import_generator_state_dict(sd, G)
    fg = _flax_g(scale)
    want = params_from_jax(jti.import_generator_state_dict(sd, fg))
    assert list(got) == list(G.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert len([k for k in got if k.startswith("upconvs.")]) == int(
        np.log2(scale))
    # the forwards: the port's module path against flax
    lr, z = _g_inputs(scale, seed=1)
    G.load_state_dict(got)
    with torch.no_grad():
        out = G.eval()(torch.from_numpy(lr), torch.from_numpy(z))
    jout = fg.apply({"params": jti.import_generator_state_dict(sd, fg)},
                    jnp.asarray(lr), jnp.asarray(z), train=False)
    _close(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("scale", [4, 8, 16])
def test_generator_export_inverts_import(scale):
    sd = _ref_g_sd(scale, seed=10 + scale)
    G = _port_g(scale)
    back = ti.export_generator_state_dict(
        ti.import_generator_state_dict(sd, G), G)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _d_pair(slicing):
    """(port D, flax D, HR input) at the tiny D: base 4, 4 z layers, 16²
    with slicing (4 blocks and the head), 32² without (5 blocks)."""
    xy = 16 if slicing else 32
    kw = dict(in_channels=3, base_features=4, number_of_z_layers=4,
              enable_slicing=slicing, dropout_probability=0.0)
    x = np.random.default_rng(5).standard_normal(
        (2, xy, xy, 4, 3)).astype(np.float32)
    return Discriminator3D(spatial=(xy, xy), **kw), FlaxD(**kw), x


def _ref_d_sd(D, seed):
    """A reference-layout D state dict with seeded values (the port's
    export names the layout; the JAX import reads it back below)."""
    sd = dict(D.state_dict())
    params = {k: v for k, v in sd.items() if k not in dict(D.named_buffers())}
    stats = {k: v for k, v in sd.items() if k in dict(D.named_buffers())}
    return _seeded(ti.export_discriminator_state_dict(params, stats, D),
                   seed, positive=("running_var",))


@pytest.mark.parametrize("slicing", [False, True])
def test_discriminator_import_matches_jax(slicing):
    D, fd, x = _d_pair(slicing)
    sd = _ref_d_sd(D, seed=3)
    params, stats = ti.import_discriminator_state_dict(sd, D)
    jparams, jstats = jti.import_discriminator_state_dict(sd, fd)
    want = d_params_from_jax(jparams, jstats)
    got = {**params, **stats}
    assert sorted(got) == sorted(want) == sorted(D.state_dict())
    assert list(stats) == [k for k, _ in D.named_buffers()]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    D.load_state_dict(got)
    with torch.no_grad():
        out = D(torch.from_numpy(x), train=False)
    jout = fd.apply({"params": jparams, "batch_stats": jstats},
                    jnp.asarray(x), train=False)
    _close(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("slicing", [False, True])
def test_discriminator_export_inverts_import(slicing):
    D, _, _ = _d_pair(slicing)
    sd = _ref_d_sd(D, seed=4)
    back = ti.export_discriminator_state_dict(
        *ti.import_discriminator_state_dict(sd, D), D)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_pth_files_cross_between_the_packages(tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads."""
    jparams = _flax_g_params(8, seed=2)
    path = jti.save_reference_checkpoint(str(tmp_path / "G_jax.pth"),
                                         jparams, _flax_g(8))
    G = _port_g(8)
    got, d, stats = ti.load_reference_checkpoint(G, path)
    assert d is None and stats is None
    want = params_from_jax(jparams)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    port = {k: v * 1.5 for k, v in want.items()}
    path = ti.save_reference_checkpoint(str(tmp_path / "G_port.pth"), port,
                                        G)
    back, _, _ = jti.load_reference_checkpoint(_flax_g(8), path)
    flat = params_from_jax(back)
    for k in port:
        assert torch.equal(flat[k], port[k]), k
    assert jax.tree.structure(back) == jax.tree.structure(
        params_to_jax(port))


def test_missing_key_or_wrong_shape_names_the_key(tmp_path):
    sd = _ref_g_sd(4)
    G = _port_g(4)
    gone = dict(sd)
    del gone["model.1.module.0.RDBs.2.LFF.bias"]
    with pytest.raises(KeyError, match=r"RDBs\.2\.LFF\.bias"):
        ti.import_generator_state_dict(gone, G)
    bad = dict(sd, **{"hr_convs.0.0.weight": torch.zeros(12, 11, 3, 3, 3)})
    with pytest.raises(ValueError, match=r"hr_convs\.0\.0\.weight"):
        ti.import_generator_state_dict(bad, G)
    D, _, _ = _d_pair(True)
    dsd = _ref_d_sd(D, 0)
    del dsd["features.2.1.1.running_mean"]
    path = str(tmp_path / "D.pth")
    torch.save(dsd, path)
    with pytest.raises(KeyError, match=r"features\.2\.1\.1\.running_mean"):
        ti.load_reference_discriminator(D, path)


# ----------------------------------------------------------------- readers
@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """A JAX state at the tiny configuration, its G as a reference
    ``G_7.pth`` the JAX package wrote, its D as a reference ``D_7.pth``
    (with moved statistics), and the same weights as a float32 pack."""
    d = tmp_path_factory.mktemp("ref")
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    js = jgan.init_state(jax.random.key(11), (1, 4, 4, 4, 4),
                         (1, 16, 16, 4, 3))
    g_path = jti.save_reference_checkpoint(str(d / "G_7.pth"),
                                           js.params_G, jgan.G)
    cfg = tiny_cfg(True)
    D = Discriminator3D(in_channels=3, base_features=4,
                        number_of_z_layers=4, enable_slicing=True,
                        spatial=(16, 16))
    d_path = str(d / "D_7.pth")
    torch.save(_ref_d_sd(D, seed=12), d_path)
    pack = str(d / "pack.npz")
    save_continuation(pack, *[jax.tree.map(np.asarray, t) for t in
                              (js.params_G, js.params_D, js.batch_stats_D)],
                      it=0, store_dtype="float32")
    params_G = params_from_jax(js.params_G)
    params_D, stats_D = ti.load_reference_discriminator(D, d_path)
    assert cfg.gan_config.slice_size == 16
    return dict(g=g_path, d=d_path, pack=pack, G=params_G, D=params_D,
                stats=stats_D)


def _equal_trees(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def test_loop_warm_starts_from_reference_files(tmp_path, ref_files):
    """G and D files: G, D and D's statistics imported, the EMA seeded from
    the imported G (not the random init), the optimizer fresh; a pack's G
    beside a reference D takes D from the file."""
    cfg = loop_cfg(True, tmp_path / "both", niter=0, g_ema_decay=0.999)
    cfg.load_model_from_save = True
    cfg.env.generator_load_path = ref_files["g"]
    cfg.env.discriminator_load_path = ref_files["d"]
    state = _train(cfg)
    _equal_trees(state.params_G, ref_files["G"], "G")
    _equal_trees(state.params_G_ema, ref_files["G"], "EMA")
    _equal_trees(state.params_D, ref_files["D"], "D")
    _equal_trees(state.batch_stats_D, ref_files["stats"], "D statistics")
    assert state.it == 0
    for opt in (state.opt_state_G, state.opt_state_D):
        assert opt.count == 0 and not any(m.any() for m in opt.mu.values())

    cfg = loop_cfg(True, tmp_path / "mixed", niter=0, g_ema_decay=0.999)
    cfg.load_model_from_save = True
    cfg.env.generator_load_path = ref_files["pack"]
    cfg.env.discriminator_load_path = ref_files["d"]
    state = _train(cfg)
    _equal_trees(state.params_G, ref_files["G"], "G")
    _equal_trees(state.params_D, ref_files["D"], "D")
    _equal_trees(state.batch_stats_D, ref_files["stats"], "D statistics")


def test_from_checkpoint_serves_a_reference_file_as_jax_does(ref_files):
    cfg = tiny_cfg(True)
    sr = WindFieldSR.from_checkpoint(cfg, ref_files["g"], COORDS, COORDS,
                                     device="cpu")
    _equal_trees(sr.G.state_dict(), ref_files["G"], "G")
    jsr = JaxWindFieldSR.from_checkpoint(tiny_cfg(False), ref_files["g"],
                                         COORDS, COORDS)
    rng = np.random.default_rng(4)
    lr = rng.standard_normal((3, 4, 4, 4, 4)).astype(np.float32)
    z = rng.standard_normal((3, 16, 16, 4, 1)).astype(np.float32)
    _close(sr.upscale(lr, z), np.asarray(jsr.upscale(lr, z)))


def test_cli_test_and_use_read_a_reference_file(tmp_path, ref_files,
                                                monkeypatch):
    """--test on the file against JAX's run_test on the same file (the same
    CSVs), --use serving the imported G with no EMA slot."""
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = _cfg(port, root, ref_files["g"])
        _, ds_test, _, x, y = _data(port, cfg)
        kw = dict(output_root=str(root / "test_output"))
        if port:
            tl.run_test(cfg, ds_test, x, y, device="cpu", **kw)
        else:
            jax_tl.run_test(cfg, ds_test, x, y, **kw)
    for f in ("averages.csv", "tinytest____metrics.csv"):
        _same_csv(tmp_path / "port" / "test_output" / f,
                  tmp_path / "jax" / "test_output" / f)

    monkeypatch.chdir(tmp_path)
    cfg = _cfg(True, tmp_path / "use", ref_files["g"])
    cfg.training.g_ema_decay = 0.999  # a slot a .pth must not fill
    ini = str(tmp_path / "use.ini")
    cfg.save(ini)
    state = run.main(["--cfg", ini, "--synthetic", "--synthetic_hours",
                      "30", "--synthetic_size", "32", "--device", "cpu",
                      "--use"])
    assert state.params_G_ema is None
    _equal_trees(state.params_G, ref_files["G"], "G")
    assert os.listdir(tmp_path / "use" / "runs")


def test_interp_blends_reference_files(tmp_path, ref_files):
    cfg = tiny_cfg(True)
    other = {k: -v for k, v in ref_files["G"].items()}
    G = _port_g(4)
    path_b = ti.save_reference_checkpoint(str(tmp_path / "G_b.pth"), other,
                                          G)
    got = interpolated_sr(cfg, ref_files["g"], path_b, 0.25, COORDS,
                          COORDS, device="cpu").G.state_dict()
    _equal_trees(got, blend_params(ref_files["G"], other, 0.25), "blend")
