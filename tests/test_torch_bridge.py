"""PyTorch port: weight bridge, continuation-pack reader, import isolation
and the device policy."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.models import Generator3D as FlaxGenerator3D
from gan_sr_wind_field_tpu.train.continuation import (
    load_continuation as jax_load_continuation,
    save_continuation,
)
from gan_sr_wind_field_tpu_torch.config import load_config
from gan_sr_wind_field_tpu_torch.models.generator import (
    Generator3D,
    generator_from_config,
)
from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    params_from_jax,
    params_to_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK_9K = os.path.join(REPO, "docs", "evidence",
                       "milestone9k_continuation_9000.npz")
TINY = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=2,
            upscale=4, hr_kern_size=3, num_rdb_convs=3,
            rdb_growth_channels=4, lff_kern_size=1, terrain_features=4)


def _flax_params(seed=0):
    G = FlaxGenerator3D(dropout_probability=0.0, **TINY)
    lr = np.zeros((1, 4, 4, 3, 4), np.float32)
    z = np.zeros((1, 16, 16, 3, 1), np.float32)
    return jax.tree.map(
        np.asarray, G.init(jax.random.key(seed), lr, z, train=False)["params"]
    )


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_bridge_round_trip():
    params = _flax_params()
    sd = params_from_jax(params)
    G = Generator3D(**TINY)
    G.load_state_dict(sd, strict=True)  # every name and shape lines up
    # conv kernels: flax (kx, ky, kz, I, O) -> torch (O, I, kx, ky, kz)
    k = params["RRDB1"]["RDB2"]["conv1"]["Conv_0"]["kernel"]
    w = G.rrdbs[1].rdbs[2].convs[1].weight.detach().numpy()
    np.testing.assert_array_equal(w, k.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        G.hr_conv1.bias.detach().numpy(), params["hr_conv1"]["bias"]
    )
    back = dict(_leaves(params_to_jax(G.state_dict())))
    want = dict(_leaves(params))
    assert back.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)


def test_pack_reader_matches_jax_loader(tmp_path):
    params = _flax_params(1)
    ema = jax.tree.map(lambda a: a * 0.5, params)
    d_params = {"Dense_0": {"kernel": np.linspace(-1, 1, 12,
                                                  dtype=np.float32)}}
    path = str(tmp_path / "pack.npz")
    save_continuation(path, params, params_D=d_params, params_G_ema=ema,
                      it=1234)
    want = jax_load_continuation(path)
    got = load_continuation(path)
    assert got["it"] == want["it"] == 1234
    assert got["batch_stats_D"] is None and want["batch_stats_D"] is None
    for key in ("params_G", "params_D", "params_G_ema"):
        g, w = dict(_leaves(got[key])), dict(_leaves(want[key]))
        assert g.keys() == w.keys()
        for leaf in w:
            assert g[leaf].dtype == np.float32
            np.testing.assert_array_equal(g[leaf], np.asarray(w[leaf]))


def test_milestone9k_pack_loads_into_full_width_generator():
    """Shapes only: the committed pack's Gema and G trees load into the
    full-width port generator with strict=True."""
    cfg = load_config(os.path.join(REPO, "configs", "milestone9k.ini"))
    G = generator_from_config(cfg, device="cpu")
    pack = load_continuation(PACK_9K)
    assert pack["it"] == 9000
    for tree in ("params_G_ema", "params_G"):
        G.load_state_dict(params_from_jax(pack[tree]), strict=True)
    assert G.rrdbs[15].rdbs[2].lff.weight.shape == (128, 256, 1, 1, 1)
    assert G.hr_conv0_x.weight.shape == (144, 128, 5, 5, 5)


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gan_sr_wind_field_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "    {'jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes',\n"
        "     'gan_sr_wind_field_tpu', 'orbax', 'matplotlib',\n"
        "     'tensorboardX'})\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('gan_sr_wind_field_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module was imported, the data feed, loop and CLI among them
    assert int(out.stdout.split()[-1]) >= 45


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for name in ("import jax", "from jax", "flax", "ml_dtypes",
                 "gan_sr_wind_field_tpu."):
        assert name not in src, name


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from gan_sr_wind_field_tpu_torch import resolve_device
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from test_train_step import tiny_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generator_from_config(cfg)
    G = generator_from_config(cfg, device="cpu")
    assert next(G.parameters()).device.type == "cpu"
    sd = G.state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindFieldSR(cfg, sd)
    sr = WindFieldSR(cfg, sd, device="cpu")
    assert sr.device.type == "cpu"
    # the training loop and the command line
    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.train.loop import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, None, None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--train", "--synthetic", "--cfg",
                  os.path.join(REPO, "configs", "milestone9k.ini")])
