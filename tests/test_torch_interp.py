"""PyTorch port: network interpolation (``eval/interp.py``) against the
JAX package, on the CPU.

- ``blend_params`` on two port state_dicts is bit-exact against JAX's on
  the flax trees of the same weights (float32 arithmetic, a·g + (1−a)·p);
- it raises on other keys or shapes and on alpha outside [0, 1];
- ``interpolated_sr`` at alpha 1 and 0 reproduces each model's generator
  exactly;
- the command line writes a port artifact that serves the blended
  generator (bit-exact against the port's ``upscale`` of the blend, and
  within JAX's export bounds, rtol 2e-4 / atol 1e-5, of JAX's
  ``generate``), and ``--stats_from`` reads a JAX-written artifact.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.eval import export as jexport
from gan_sr_wind_field_tpu.eval.interp import blend_params as jax_blend
from gan_sr_wind_field_tpu.train.continuation import save_continuation
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.eval.export import (
    load_exported,
    read_header,
)
from gan_sr_wind_field_tpu_torch.eval.interp import (
    blend_params,
    interpolated_sr,
    main,
)
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax
from gan_sr_wind_field_tpu_torch.utils.torch_import import (
    save_reference_checkpoint,
)

COORDS = np.arange(16, dtype=np.float32) * 150.0
STATS = {"z_min": -2.7, "z_max": 550.4, "z_above_ground_max": 68.5,
         "uvw_max": 32.33, "p_min": 0.0, "p_max": 105182.8}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Two JAX generators of one architecture, as flax trees and as
    float32 continuation packs (no EMA slot: the packs serve G)."""
    gan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    d = tmp_path_factory.mktemp("packs")
    trees, paths = [], []
    for seed in (1, 2):
        s = gan.init_state(jax.random.key(seed), (1, 4, 4, 4, 4),
                           (1, 16, 16, 4, 3))
        t = [jax.tree.map(np.asarray, v)
             for v in (s.params_G, s.params_D, s.batch_stats_D)]
        path = str(d / f"g{seed}.npz")
        save_continuation(path, *t, it=0, store_dtype="float32")
        trees.append(t[0])
        paths.append(path)
    return gan, trees, paths


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.8, 1.0])
def test_blend_params_is_bit_exact_against_jax(two, alpha):
    _, (a, b), _ = two
    got = blend_params(params_from_jax(a), params_from_jax(b), alpha)
    want = params_from_jax(jax.tree.map(np.asarray, jax_blend(a, b, alpha)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_blend_params_validates(two):
    _, (a, b), _ = two
    pa, pb = params_from_jax(a), params_from_jax(b)
    for alpha in (-0.1, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            blend_params(pa, pb, alpha)
    fewer = dict(pb)
    fewer.pop("hr_conv1.bias")
    wider = dict(pb)
    wider["hr_conv1.bias"] = torch.zeros(4)
    for other in (fewer, wider):
        with pytest.raises(ValueError, match="same architecture"):
            blend_params(pa, other, 0.5)
    # a bf16 tensor is blended in float32 and cast back
    bf = {k: v.to(torch.bfloat16) for k, v in pa.items()}
    out = blend_params(bf, pb, 0.5)
    assert all(v.dtype == torch.bfloat16 for v in out.values())


def test_alpha_endpoints_reproduce_each_model(two, tmp_path):
    _, _, (path_a, path_b) = two
    cfg = tiny_cfg(True)
    for alpha, path in ((1.0, path_a), (0.0, path_b)):
        got = interpolated_sr(cfg, path_a, path_b, alpha, COORDS, COORDS,
                              device="cpu").G.state_dict()
        want = WindFieldSR.from_checkpoint(cfg, path, COORDS, COORDS,
                                           device="cpu").G.state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (alpha, k)
    # a reference G_{it}.pth of model a blends as a's pack does
    a = WindFieldSR.from_checkpoint(cfg, path_a, COORDS, COORDS,
                                    device="cpu")
    pth = save_reference_checkpoint(str(tmp_path / "G_100.pth"),
                                    a.G.state_dict(), a.G)
    got = interpolated_sr(cfg, pth, path_b, 0.5, COORDS, COORDS,
                          device="cpu").G.state_dict()
    want = interpolated_sr(cfg, path_a, path_b, 0.5, COORDS, COORDS,
                           device="cpu").G.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_writes_a_blended_artifact(two, tmp_path):
    gan, (a, b), (path_a, path_b) = two
    cfg = tiny_cfg(True)
    ini = str(tmp_path / "arch.ini")
    cfg.save(ini)
    # norm_stats from an artifact the JAX package wrote (format v1)
    donor = str(tmp_path / "donor.wsrx")
    jexport.export_generator(gan, a, donor, norm_stats=STATS)
    out = str(tmp_path / "blend.wsrx")
    assert main(["--cfg", ini, "--gan", path_a, "--psnr", path_b,
                 "--alpha", "0.8", "--out", out, "--stats_from", donor,
                 "--device", "cpu"]) == 0
    header = read_header(out)
    assert header["format_version"] == 2 and header["norm_stats"] == STATS
    sr = load_exported(out, device="cpu")
    rng = np.random.default_rng(3)
    lr = (rng.standard_normal((2, 4, 4, 4, 4)) * 0.3).astype(np.float32)
    zt = rng.standard_normal((2, 16, 16, 4, 1)).astype(np.float32)
    got = sr.upscale(lr, zt)
    blended = blend_params(params_from_jax(a), params_from_jax(b), 0.8)
    np.testing.assert_array_equal(
        got, WindFieldSR(cfg, blended, device="cpu").upscale(lr, zt))
    want = np.asarray(gan.generate(jax_blend(a, b, 0.8), lr, zt))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert not np.array_equal(
        got, WindFieldSR(cfg, params_from_jax(a), device="cpu").upscale(
            lr, zt))
    # physical units through the copied stats
    lr_uvw = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    z = np.cumsum(rng.random((16, 16, 4)).astype(np.float32) * 50, axis=2)
    np.testing.assert_array_equal(
        sr.upscale_physical(lr_uvw, z),
        WindFieldSR(cfg, blended, device="cpu",
                    norm_stats=STATS).upscale_physical(lr_uvw, z))
    # a donor without stats is refused with a clear message
    bare = str(tmp_path / "bare.wsrx")
    jexport.export_generator(gan, a, bare)
    with pytest.raises(SystemExit, match="no norm_stats"):
        main(["--cfg", ini, "--gan", path_a, "--psnr", path_b, "--alpha",
              "0.5", "--out", out, "--stats_from", bare, "--device", "cpu"])
