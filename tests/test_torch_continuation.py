"""PyTorch port: the continuation-pack writer and ``from_checkpoint``
against the JAX package, on the CPU at the tiny configuration of
``tests/_torch_tiny.py``.

- a pack the port writes from a port state loads in the JAX
  ``load_continuation`` bit for bit, in bf16 and float32 storage, and is,
  key for key and meta for meta, the pack the JAX ``save_continuation``
  writes from the same weights bridged with ``params_to_jax``;
- ``f32_to_bf16_bits`` rounds as ``ml_dtypes.bfloat16``, bit for bit
  (the port itself does not import ``ml_dtypes``);
- the JAX ``WindFieldSR`` on the port's pack upscales as the port's
  ``from_continuation`` does, within 1e-5 (float32 storage);
- ``from_checkpoint`` after a 4-step leg of the port's loop serves the
  state's EMA, and its raw G with ``use_ema=False``, bit for bit; so does
  the server's ``--checkpoint``, which excludes ``--continuation``;
- the readers of weights take a checkpoint whose random generator state is
  of another device type (a card's), while a resume refuses it.
"""

import dataclasses
import json
import shutil

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxWindFieldSR
from gan_sr_wind_field_tpu.train import continuation as jax_cont
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.eval import server
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.continuation import (
    f32_to_bf16_bits,
    pack_from_state,
)
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_to_jax,
    params_to_jax,
)
from test_torch_loop import _train, loop_cfg


@pytest.fixture(scope="module")
def port_state():
    """A port state one G step from init, so G, its EMA and D differ."""
    cfg = tiny_cfg(True, g_ema_decay=0.5)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    state, _ = gan.train_step(state, *make_batch(5))
    return state


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("store_dtype", ["bfloat16", "float32"])
def test_port_pack_is_the_jax_pack(tmp_path, port_state, store_dtype):
    s = port_state
    mine = pack_from_state(str(tmp_path / "port.npz"), s,
                           store_dtype=store_dtype, extra_meta={"name": "x"})
    params_D, stats = d_params_to_jax({**s.params_D, **s.batch_stats_D})
    theirs = jax_cont.save_continuation(
        str(tmp_path / "jax.npz"), params_to_jax(s.params_G), params_D,
        stats, params_to_jax(s.params_G_ema), it=s.it,
        store_dtype=store_dtype, extra_meta={"name": "x"})
    a, b = _npz(mine), _npz(theirs)
    assert sorted(a) == sorted(b)
    assert json.loads(str(a.pop("__meta__"))) == json.loads(
        str(b.pop("__meta__")))
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    # JAX reads it back as the state's weights, rounded as stored
    got = jax_cont.load_continuation(mine)
    assert got["it"] == s.it == 1
    assert got["meta"]["trees"] == ["G", "D", "Dstats", "Gema"]
    want = {"params_G": params_to_jax(s.params_G), "params_D": params_D,
            "batch_stats_D": stats,
            "params_G_ema": params_to_jax(s.params_G_ema)}
    for tree, ref in want.items():
        ref = dict(_leaves(ref))
        leaves = dict(_leaves(got[tree]))
        assert sorted(leaves) == sorted(ref), tree
        for k, v in ref.items():
            if store_dtype == "bfloat16":
                v = v.astype(ml_dtypes.bfloat16).astype(np.float32)
            assert np.array_equal(leaves[k], v), f"{tree}/{k}"


def test_empty_d_statistics_are_left_out(tmp_path, port_state):
    s = dataclasses.replace(port_state, batch_stats_D={})
    path = pack_from_state(str(tmp_path / "p.npz"), s, include_ema=False)
    meta = jax_cont.load_continuation(path)["meta"]
    assert meta["trees"] == ["G", "D"]


_EDGES = np.array(
    [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
     0x7F800001, 0xFFBFFFFF, 0x7FC12345, 0xFFFFFFFF,  # inf, NaNs
     0x00000001, 0x00008000, 0x00018000, 0x807FFFFF,  # subnormals
     0x3F808000, 0x3F818000, 0x3F807FFF, 0xBF808001,  # ties and near
     0x7F7FFFFF, 0x7F7F8000, 0xFF7F7FFF], np.uint32)   # the largest


def _ml_dtypes_bits(bits: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return (bits.view(np.float32).astype(ml_dtypes.bfloat16)
                .view(np.uint16))


def test_f32_to_bf16_bits_edges():
    got = f32_to_bf16_bits(_EDGES.view(np.float32))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, _ml_dtypes_bits(_EDGES))
    assert f32_to_bf16_bits(np.float32(1.0)) == 0x3F80


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=64))
def test_f32_to_bf16_bits_matches_ml_dtypes(words):
    bits = np.array(words, np.uint32)
    np.testing.assert_array_equal(f32_to_bf16_bits(bits.view(np.float32)),
                                  _ml_dtypes_bits(bits))


def test_jax_serves_the_port_pack(tmp_path, port_state):
    path = pack_from_state(str(tmp_path / "p.npz"), port_state,
                           store_dtype="float32")
    pack = jax_cont.load_continuation(path)
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    jax_sr = JaxWindFieldSR(jgan, jax.tree.map(jnp.asarray,
                                               pack["params_G_ema"]))
    port_sr = WindFieldSR.from_continuation(tiny_cfg(True), path,
                                            device="cpu")
    assert port_sr.packed is not None
    rng = np.random.default_rng(6)
    lr = rng.standard_normal((3, 6, 5, 4, 4)).astype(np.float32)
    z = rng.standard_normal((3, 24, 20, 4, 1)).astype(np.float32)
    np.testing.assert_allclose(port_sr.upscale(lr, z),
                               np.asarray(jax_sr.upscale(lr, z)),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-step leg of the port's loop: (its config, final state, last
    checkpoint)."""
    cfg = loop_cfg(True, tmp_path_factory.mktemp("leg"), niter=4,
                   g_ema_decay=0.999)
    state = _train(cfg)
    path = ckpt.latest_checkpoint(cfg.env.this_runs_folder)
    assert path.endswith("ckpt_4")
    return cfg, state, path


def test_from_checkpoint_serves_the_trained_state(trained, tmp_path):
    cfg, state, path = trained
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    lr, _, z = make_batch(7, n=2, size=32)
    for use_ema, params in ((True, state.params_G_ema),
                            (False, state.params_G)):
        sr = WindFieldSR.from_checkpoint(cfg, path, COORDS, COORDS,
                                         use_ema=use_ema, device="cpu")
        want = gan.generate(dataclasses.replace(state, params_G=params),
                            lr, z)
        assert torch.equal(torch.from_numpy(sr.upscale(lr, z)), want)
    assert not torch.equal(state.params_G["feature_conv.weight"],
                           state.params_G_ema["feature_conv.weight"])
    with pytest.raises(NotImplementedError, match="torch_import"):
        WindFieldSR.from_checkpoint(cfg, str(tmp_path / "G_4.pth"), COORDS,
                                    COORDS, device="cpu")


def test_weights_readers_take_a_checkpoint_of_another_device_type(
        trained, tmp_path):
    """A checkpoint saved on the card holds a 16-byte random generator
    state (seed and offset) that no CPU generator takes: evaluating,
    serving and warm-starting from it read its weights only, a resume
    raises ``ValueError``."""
    cfg, state, path = trained
    card = str(tmp_path / "ckpt_4")
    shutil.copytree(path, card)
    blob = torch.load(f"{card}/{ckpt.STATE_FILE}", weights_only=True)
    blob["rng_state"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(blob, f"{card}/{ckpt.STATE_FILE}")
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    got = ckpt.load_generator_state(cfg, gan, card)
    for tree in ("params_G", "params_G_ema"):
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(got, tree)[k], v), (tree, k)
    lr, _, z = make_batch(7, n=1, size=16)
    sr = WindFieldSR.from_checkpoint(cfg, card, COORDS, COORDS,
                                     device="cpu")
    want = gan.generate(dataclasses.replace(state,
                                            params_G=state.params_G_ema),
                        lr, z)
    assert torch.equal(torch.from_numpy(sr.upscale(lr, z)), want)
    with pytest.raises(ValueError, match="random generator state"):
        ckpt.restore_checkpoint(card, ckpt.training_example(cfg, gan))
    warm = loop_cfg(True, tmp_path / "warm", niter=0, g_ema_decay=0.999)
    warm.load_model_from_save = True
    warm.env.generator_load_path = card
    for k, v in _train(warm).params_G.items():
        assert torch.equal(v, state.params_G[k]), k


def test_server_main_takes_a_checkpoint(trained, tmp_path, monkeypatch,
                                        capsys):
    cfg, state, path = trained
    ini = str(tmp_path / "run.ini")
    cfg.save(ini)
    captured = {}
    monkeypatch.setattr(server, "serve",
                        lambda backend, **kw: captured.update(backend=backend))
    assert server.main(["--cfg", ini, "--checkpoint", path, "--device",
                        "cpu", "--port", "0"]) == 0
    assert f"serving {path} " in capsys.readouterr().out
    lr, _, z = make_batch(8, n=1, size=16)
    want = WindFieldSR(cfg, state.params_G_ema, device="cpu")
    np.testing.assert_array_equal(captured["backend"].upscale(lr, z),
                                  want.upscale(lr, z))
    for weights in ([], ["--checkpoint", path, "--continuation", "p.npz"]):
        with pytest.raises(SystemExit):
            server.main(["--cfg", ini, "--device", "cpu", *weights])
