"""PyTorch port: the serving slice end to end against the JAX package.

Port ``WindFieldSR.upscale``/``upscale_physical`` against the JAX
``WindFieldSR`` on a tiny config with the same weights (bridged), then the
port's ``MicroBatcher`` and HTTP server around the port backend. CPU,
float32, tolerance 1e-5.
"""

import io
import urllib.request

import jax
import numpy as np
import pytest

from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxWindFieldSR
from gan_sr_wind_field_tpu.eval.serve import (
    _cosine_window as jax_cosine_window,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.eval.serve import (
    WindFieldSR,
    _cosine_window,
    _tiling,
)
from gan_sr_wind_field_tpu_torch.eval.server import MicroBatcher, serve
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax
from test_train_step import tiny_cfg

STATS = {"z_min": 0.0, "z_max": 500.0, "z_above_ground_max": 300.0,
         "uvw_max": 20.0, "p_min": 9.0e4, "p_max": 1.0e5}


def _cfg():
    cfg = tiny_cfg()
    cfg.generator.dropout_probability = 0.0
    cfg.generator.num_RRDB = 2
    cfg.generator.num_RDB_convs = 3
    cfg.generator.weight_init_scale = 0.5
    cfg.use_fused_trunk = True
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    x = np.arange(16, dtype=np.float32) * 150
    gan = WindFieldGAN(cfg, x, x)
    state = gan.init_state(jax.random.key(0), (1, 4, 4, 4, 4),
                           (1, 16, 16, 4, 3))
    params = jax.tree.map(np.asarray, state.params_G)
    jax_sr = JaxWindFieldSR(gan, state.params_G, norm_stats=STATS)
    port_sr = WindFieldSR(cfg, params_from_jax(params), device="cpu",
                          norm_stats=STATS)
    return jax_sr, port_sr


def _sample(rng, n=None):
    lead = () if n is None else (n,)
    lr = rng.standard_normal(lead + (4, 4, 4, 4)).astype(np.float32)
    z = rng.standard_normal(lead + (16, 16, 4, 1)).astype(np.float32)
    return lr, z


def test_upscale_matches_jax(pair):
    jax_sr, port_sr = pair
    assert port_sr.packed is not None  # the trunk goes through rrdb_trunk
    rng = np.random.default_rng(0)
    for n in (None, 3):
        lr, z = _sample(rng, n)
        got = port_sr.upscale(lr, z)
        assert got.dtype == np.float32
        assert got.shape == (() if n is None else (n,)) + (16, 16, 4, 3)
        np.testing.assert_allclose(got, np.asarray(jax_sr.upscale(lr, z)),
                                   rtol=1e-5, atol=1e-5)


def test_upscale_physical_matches_jax(pair):
    jax_sr, port_sr = pair
    rng = np.random.default_rng(1)
    lr_uvw = rng.standard_normal((2, 4, 4, 4, 3)).astype(np.float32) * 8
    z = np.cumsum(rng.random((2, 16, 16, 4)).astype(np.float32) * 50, axis=3)
    got = port_sr.upscale_physical(lr_uvw, z)
    want = np.asarray(jax_sr.upscale_physical(lr_uvw, z))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert port_sr.lr_channels == jax_sr.lr_channels


def test_upscale_physical_needs_norm_stats(pair):
    _, port_sr = pair
    bare = WindFieldSR(port_sr.cfg, port_sr.G.state_dict(), device="cpu")
    with pytest.raises(ValueError):
        bare.upscale_physical(np.zeros((4, 4, 4, 3)), np.zeros((16, 16, 4)))


def test_micro_batcher_round_trip(pair):
    _, port_sr = pair
    rng = np.random.default_rng(2)
    lrs, zs = _sample(rng, 3)
    batcher = MicroBatcher(port_sr, max_batch=8, max_wait_ms=20.0)
    try:
        outs = batcher.submit_many(list(lrs), list(zs), timeout=60.0)
        single = batcher.submit(lrs[0], zs[0], timeout=60.0)
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()
    want = port_sr.upscale(lrs, zs)
    np.testing.assert_allclose(np.stack(outs), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(single, want[0], rtol=1e-5, atol=1e-6)
    assert batcher.stats["requests"] == 4 and batcher.stats["errors"] == 0


def test_http_round_trip(pair):
    _, port_sr = pair
    rng = np.random.default_rng(3)
    lr, z = _sample(rng, 2)
    srv = serve(port_sr, host="127.0.0.1", port=0, max_wait_ms=5.0)
    try:
        buf = io.BytesIO()
        np.savez(buf, lr=lr, z=z)
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/upscale"
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            sr = np.load(io.BytesIO(resp.read()))["sr"]
    finally:
        srv.close()
    np.testing.assert_allclose(sr, port_sr.upscale(lr, z), rtol=1e-5,
                               atol=1e-6)


def test_tiled_upscale_via_matches_jax_copy():
    """The port's copy of the tiling helper blends like the JAX one."""
    from gan_sr_wind_field_tpu.eval.server import (
        tiled_upscale_via as jax_tiled,
    )
    from gan_sr_wind_field_tpu_torch.eval.server import tiled_upscale_via

    def submit_many(lrs, zs):  # a linear stand-in for the generator
        return [np.repeat(np.repeat(lr[..., :3], 4, 0), 4, 1) + 0.1 * z
                for lr, z in zip(lrs, zs)]

    rng = np.random.default_rng(4)
    lr = rng.standard_normal((10, 7, 4, 4)).astype(np.float32)
    z = rng.standard_normal((40, 28, 4, 1)).astype(np.float32)
    got = tiled_upscale_via(submit_many, lr, z, 4, tile=4, overlap=1)
    want = jax_tiled(submit_many, lr, z, 4, tile=4, overlap=1)
    assert got.shape == (40, 28, 4, 3)
    np.testing.assert_array_equal(got, want)


def _field(rng, X, Y):
    """One LR field (X, Y, 4, 4) and its terrain at 4x."""
    lr = rng.standard_normal((X, Y, 4, 4)).astype(np.float32)
    z = rng.standard_normal((4 * X, 4 * Y, 4, 1)).astype(np.float32)
    return lr, z


@pytest.mark.parametrize("n", [1, 3, 7, 16, 64])
def test_cosine_window_matches_jax(n):
    np.testing.assert_array_equal(_cosine_window(n), jax_cosine_window(n))


@pytest.mark.parametrize("X,Y,tile,overlap,batch", [
    (10, 7, 4, 2, 1),   # 12 tiles, one at a time
    (10, 7, 4, 2, 4),   # 3 batches of 4
    (9, 9, 4, 2, 4),    # 16 tiles, the last origins clamped
    (6, 11, 4, 1, 3),   # a last batch padded under a zero mask
    (4, 4, 4, 2, 4),    # the tile covers the field: one upscale
    (3, 10, 4, 2, 2),   # a side smaller than the tile: tile 3, overlap 2
    (3, 10, 4, 3, 2),   # ... whose overlap no longer fits: overlap 0
])
def test_upscale_tiled_matches_jax(pair, X, Y, tile, overlap, batch):
    jax_sr, port_sr = pair
    lr, z = _field(np.random.default_rng(X * 100 + Y), X, Y)
    got = port_sr.upscale_tiled(lr, z, tile=tile, overlap=overlap,
                                batch=batch)
    want = np.asarray(jax_sr.upscale_tiled(lr, z, tile=tile,
                                           overlap=overlap, batch=batch))
    assert got.dtype == np.float32 and got.shape == (4 * X, 4 * Y, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 4, 5])
def test_upscale_tiled_is_the_host_loop(pair, batch):
    """The device pipeline against ``_upscale_tiled_host`` on the same
    tiles: the same forwards, blended in another place."""
    _, port_sr = pair
    lr, z = _field(np.random.default_rng(batch), 11, 9)
    tile, win, coords = _tiling(11, 9, 4, 2, batch, port_sr.scale)
    want = port_sr._upscale_tiled_host(lr, z, coords, tile, batch, win)
    got = port_sr.upscale_tiled(lr, z, tile=4, overlap=2, batch=batch)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_upscale_physical_tiled_matches_jax(pair):
    jax_sr, port_sr = pair
    rng = np.random.default_rng(5)
    lr_uvw = rng.standard_normal((9, 6, 4, 3)).astype(np.float32) * 8
    z = np.cumsum(rng.random((36, 24, 4)).astype(np.float32) * 50, axis=2)
    kw = dict(tiled=True, tile=4, overlap=2, batch=3)
    got = port_sr.upscale_physical(lr_uvw, z, **kw)
    want = np.asarray(jax_sr.upscale_physical(lr_uvw, z, **kw))
    assert got.shape == (36, 24, 4, 3)
    # the model-space tolerance of test_upscale_tiled_matches_jax, in m/s
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * STATS["uvw_max"])


@pytest.mark.parametrize("kw,match", [
    (dict(tile=4, overlap=4), "overlap"),
    (dict(tile=4, overlap=6), "overlap"),
    (dict(tile=4, overlap=1, batch=0), "batch"),
])
def test_upscale_tiled_rejects_what_jax_rejects(pair, kw, match):
    jax_sr, port_sr = pair
    lr, z = _field(np.random.default_rng(6), 8, 8)
    for sr in (jax_sr, port_sr):
        with pytest.raises(ValueError, match=match):
            sr.upscale_tiled(lr, z, **kw)
