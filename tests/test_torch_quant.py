"""PyTorch port: int8 serving (``ops/conv_int8.py``, ``ops/quant.py``,
``ops/quant_trunk.py``, ``WindFieldSR.quantize``/``quantize_trunk``/
``dequantize``, ``WindFieldGAN.generate_quantized`` and the command line's
``--serve_int8``/``--serve_int8_trunk``) against the JAX package, on the
CPU with numpy inputs from a seed. JAX's fused trunk runs in interpret
mode, as its own tests run it.

Tolerances, each with its reason:

- the quantizers (``fold_quantize_kernel``, ``quantize_act``,
  ``scales_from_amax``, ``quantize_split_head``, ``quantize_trunk``) on the
  same inputs: exactly JAX's int8 tensors and float32 scales;
- ``conv3d_int8_reference`` on integer data: exactly JAX's int32 sums;
- ``split_head_conv_int8`` at full channel width (128 -> 144, JAX's
  128 + 16 split): <= 1e-6 relative, the shifted float32 sum's order;
- ``trunk_reference_amax``'s forward and amaxes: <= 1e-5 relative (float32
  convs in two libraries), ``trunk_int8_apply`` on the same quantized
  trunk <= 1e-5 relative;
- serving end to end: the calibrated scales within 1e-5 of JAX's (the
  calibration probes run float32 convs of two libraries), the quantized
  output within 1e-4 relative of JAX's (2.9e-7 measured; an activation
  within rounding of an int8 step may round the other way, one step of
  1/127 of its channel's range), and within JAX's own bounds of the exact
  path: 2e-2 (head), 3e-2 (trunk), 4e-2 (both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxSR
from gan_sr_wind_field_tpu.ops import quant as jq
from gan_sr_wind_field_tpu.ops import quant_trunk as jqt
from gan_sr_wind_field_tpu.train.continuation import (
    load_continuation as jax_load_continuation,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.eval import server
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.models.fused_apply import generator_forward
from gan_sr_wind_field_tpu_torch.ops import conv_int8
from gan_sr_wind_field_tpu_torch.ops import quant as pq
from gan_sr_wind_field_tpu_torch.ops import quant_trunk as pqt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax
from test_torch_test_loop import HOURS, SIZE, _cfg, _cli, pack  # noqa: F401

COORDS = np.arange(16, dtype=np.float32) * 150.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


# ------------------------------------------------------------- quantizers
def test_quantizers_match_jax_exactly():
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((3, 3, 3, 6, 12)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, 4, 4, 3, 6)) * 2.0).astype(np.float32)
    amax = np.abs(x).max(axis=(0, 1, 2, 3))
    s_in = np.asarray(jq.scales_from_amax(amax))
    np.testing.assert_array_equal(pq.scales_from_amax(amax).numpy(), s_in)
    np.testing.assert_array_equal(
        pq.head_input_amax(_t(x)).numpy(),
        np.asarray(jq.head_input_amax(jnp.asarray(x))))
    wq, s_out = jq.fold_quantize_kernel(jnp.asarray(kernel),
                                        jnp.asarray(s_in))
    pwq, ps_out = pq.fold_quantize_kernel(_t(kernel), _t(s_in))
    assert pwq.dtype == torch.int8
    np.testing.assert_array_equal(pwq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(ps_out.numpy(), np.asarray(s_out))
    # half-to-even rounding and the clip, as jnp.round
    xs = np.concatenate([x.ravel(), [0.5, 1.5, -2.5, 300.0, -300.0]])
    xs = xs.astype(np.float32).reshape(-1, 1)
    one = np.ones(1, np.float32)
    np.testing.assert_array_equal(
        pq.quantize_act(_t(xs), _t(one)).numpy(),
        np.asarray(jq.quantize_act(jnp.asarray(xs), jnp.asarray(one))))


@pytest.mark.parametrize("k,pad", [((3, 3, 3), 1), ((1, 1, 5), (0, 0, 2)),
                                   ((1, 1, 1), 0), ((5, 5, 5), 2)])
def test_conv3d_int8_reference_equals_jax_on_integer_data(k, pad):
    rng = np.random.default_rng(sum(k))
    xq = rng.integers(-127, 128, (2, 6, 5, 4, 20)).astype(np.int8)
    wq = rng.integers(-127, 128, (*k, 20, 9)).astype(np.int8)
    want = np.asarray(jq.conv3d_int8(jnp.asarray(xq), jnp.asarray(wq), pad))
    got = conv_int8.conv3d_int8_reference(_t(xq), _t(wq), pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # dequantized as the kernel's epilogue: float32 acc * s, then + b
    s = rng.uniform(1e-4, 1e-2, 9).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    before = conv_int8.launches
    deq = conv_int8.conv3d_int8(_t(xq), _t(wq), pad, _t(s), _t(b))
    assert conv_int8.launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(
        deq.numpy(), (want.astype(np.float32) * s) + b)


def test_split_head_matches_jax_at_full_channel_width():
    """128 -> 144 at k = 5: JAX's 128-channel main kernel and its 16-channel
    remainder stacked over the 25 (x, y) taps, same int8 weights and
    scales, the output within 1e-6 relative."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1, 8, 8, 3, 128)) * 1.5).astype(np.float32)
    kernel = (rng.standard_normal((5, 5, 5, 128, 144)) * 0.02).astype(
        np.float32)
    s_in = jq.scales_from_amax(jq.head_input_amax(jnp.asarray(x)))
    jqh = jq.quantize_split_head(jnp.asarray(kernel), s_in)
    pqh = pq.quantize_split_head(_t(kernel), pq.scales_from_amax(
        pq.head_input_amax(_t(x))))
    assert (pqh.k, pqh.cm, pqh.cr) == (jqh.k, jqh.cm, jqh.cr) == (
        (5, 5, 5), 128, 16)
    for name in ("s_in", "wq_main", "s_main", "wq_rem", "s_rem"):
        np.testing.assert_array_equal(getattr(pqh, name).numpy(),
                                      np.asarray(getattr(jqh, name)),
                                      err_msg=name)
    assert tuple(pqh.packed_rem.shape) == (1, 1, 5, 400, 128)
    want = np.asarray(jq.split_head_conv_int8(jnp.asarray(x), jqh, 2,
                                              out_dtype=jnp.float32))
    got = pq.split_head_conv_int8(_t(x), pqh, 2, out_dtype=torch.float32)
    assert got.shape == (1, 8, 8, 3, 144)
    assert _rel(got.numpy(), want) <= 1e-6


# ------------------------------------------------------------------ trunk
@pytest.fixture(scope="module")
def trunk_setup():
    cfg = tiny_cfg(False, num_rdb_convs=3)
    cfg.generator.num_RRDB = 2
    gan = JaxGAN(cfg, COORDS, COORDS)
    state = gan.init_state(jax.random.key(0), (2, 4, 4, 4, 4),
                           (2, 16, 16, 4, 3))
    params = jax.tree.map(np.asarray, state.params_G)
    G = gan.G
    geom = dict(num_rrdb=G.num_rrdb, num_convs=G.num_rdb_convs,
                lff_kern=G.lff_kern_size, rdb_scale=G.rdb_residual_scaling,
                rrdb_scale=G.rrdb_residual_scaling,
                negative_slope=G.negative_slope)
    return params, params_from_jax(params), geom


def test_trunk_quantization_matches_jax(trunk_setup):
    params, port_params, geom = trunk_setup
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4, 4, 4, 8)) * 0.5).astype(np.float32)
    y, ax, ac = jqt.trunk_reference_amax(params, jnp.asarray(x), **geom)
    py, pax, pac = pqt.trunk_reference_amax(port_params, _t(x), **geom)
    assert pax.shape == (6, 8) and pac.shape == (6, 2, 4)
    for got, want in ((py, y), (pax, ax), (pac, ac)):
        assert _rel(got.numpy(), want) <= 1e-5
    # the same amaxes fold into the same int8 weights and scales
    ax, ac = np.asarray(ax), np.asarray(ac)
    jt = jqt.quantize_trunk(params, ax, ac, **geom)
    pt = pqt.quantize_trunk(port_params, _t(ax), _t(ac), **geom)
    for name in ("s_x", "s_c", "wq_lff", "sw_lff", "b_lff"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for k in range(geom["num_convs"] - 1):
        np.testing.assert_array_equal(pt.wq[k].numpy(), np.asarray(jt.wq[k]))
        np.testing.assert_array_equal(pt.sw[k].numpy(), np.asarray(jt.sw[k]))
    want = np.asarray(jqt.trunk_int8_apply(jt, jnp.asarray(x),
                                           out_dtype=jnp.float32))
    before = conv_int8.launches
    got = pqt.trunk_int8_apply(pt, _t(x), out_dtype=torch.float32)
    assert conv_int8.launches == before
    assert _rel(got.numpy(), want) <= 1e-5
    assert 0 < _rel(got.numpy(), np.asarray(y)) < 0.02


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def serving():
    """A JAX WindFieldSR and the port's on the same weights (2 RRDB, 3
    convs), with three calibration fields and a terrain."""
    cfg = tiny_cfg(False, num_rdb_convs=3)
    cfg.generator.num_RRDB = 2
    gan = JaxGAN(cfg, COORDS, COORDS)
    state = gan.init_state(jax.random.key(4), (1, 4, 4, 4, 4),
                           (1, 16, 16, 4, 3))
    params = jax.tree.map(np.asarray, state.params_G)
    pcfg = tiny_cfg(True, num_rdb_convs=3)
    pcfg.generator.num_RRDB = 2
    rng = np.random.default_rng(5)
    lr = (rng.standard_normal((3, 4, 4, 4, 4)) * 0.3).astype(np.float32)
    zt = (np.cumsum(1.0 + rng.random((3, 16, 16, 4, 1)), axis=3)
          * 10.0).astype(np.float32)
    return (lambda: JaxSR(gan, state.params_G),
            lambda: WindFieldSR(pcfg, params_from_jax(params),
                                device="cpu"),
            lr, zt)


@pytest.mark.parametrize("parts,tol", [(("head",), 2e-2), (("trunk",), 3e-2),
                                       (("head", "trunk"), 4e-2)])
def test_quantized_serving_matches_jax(serving, parts, tol):
    make_jax, make_port, lr, zt = serving
    jsr, psr = make_jax(), make_port()
    exact = psr.upscale(lr, zt)
    np.testing.assert_allclose(exact, np.asarray(jsr.upscale(lr, zt)),
                               rtol=1e-5, atol=1e-5)
    if "head" in parts:
        jqh, pqh = jsr.quantize(lr), psr.quantize(lr)
        assert isinstance(pqh, pq.QuantizedHead)
        assert _rel(pqh.s_in.numpy(), np.asarray(jqh.s_in)) <= 1e-5
    if "trunk" in parts:
        jqt_, pqt_ = jsr.quantize_trunk(lr), psr.quantize_trunk(lr)
        assert isinstance(pqt_, pqt.QuantizedTrunk)
        assert _rel(pqt_.s_x.numpy(), np.asarray(jqt_.s_x)) <= 1e-5
        assert _rel(pqt_.s_c.numpy(), np.asarray(jqt_.s_c)) <= 1e-5
    got = psr.upscale(lr, zt)
    assert got.shape == exact.shape and np.isfinite(got).all()
    assert not np.array_equal(got, exact)  # the quantized path ran
    assert _rel(got, np.asarray(jsr.upscale(lr, zt))) <= 1e-4
    assert _rel(got, exact) < tol
    # tiled, as JAX tiles it (the quantized forward on every tile)
    field = np.tile(lr[0], (2, 2, 1, 1))
    zfield = np.tile(zt[0], (2, 2, 1, 1))
    tiled = psr.upscale_tiled(field, zfield, tile=4, overlap=2, batch=2)
    assert _rel(tiled, np.asarray(jsr.upscale_tiled(
        field, zfield, tile=4, overlap=2, batch=2))) <= 1e-4
    psr.dequantize()
    np.testing.assert_array_equal(psr.upscale(lr, zt), exact)


def test_generate_quantized_matches_the_served_forward(serving):
    make_jax, make_port, lr, zt = serving
    psr = make_port()
    qh, qt = psr.quantize(lr), psr.quantize_trunk(lr)
    gan = WindFieldGAN(psr.cfg, COORDS, COORDS, device="cpu")
    got = gan.generate_quantized(psr.G.state_dict(), qh, lr, zt, qt)
    np.testing.assert_array_equal(got.numpy(), psr.upscale(lr, zt))
    jsr = make_jax()
    jsr.quantize(lr)
    jsr.quantize_trunk(lr)
    assert _rel(got.numpy(), np.asarray(jsr.upscale(lr, zt))) <= 1e-4


def test_quantized_serving_needs_the_fused_trunk(serving):
    """Both calibrations raise, as JAX's do, before calibrating; so do
    generate_quantized and a qhead in training mode."""
    _, make_port, lr, zt = serving
    psr = make_port()
    cfg = tiny_cfg(True, num_rdb_convs=3)
    cfg.generator.num_RRDB = 2
    cfg.use_fused_trunk = False
    bare = WindFieldSR(cfg, psr.G.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="fused-trunk"):
        bare.quantize(lr)
    with pytest.raises(ValueError, match="fused-trunk"):
        bare.quantize_trunk(lr)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    qh = psr.quantize(lr)
    with pytest.raises(ValueError, match="fused-trunk"):
        gan.generate_quantized(psr.G.state_dict(), qh, lr, zt)
    with pytest.raises(ValueError, match="serving-only"):
        generator_forward(psr.G, _t(lr), _t(zt), lambda f: f, train=True,
                          qhead=qh)


# ---------------------------------------------------------- command line
@pytest.mark.parametrize("flag,attr,calibrate", [
    ("--serve_int8", "qhead", "quantize"),
    ("--serve_int8_trunk", "qtrunk", "quantize_trunk")])
def test_cli_serve_int8_calibrates_on_the_test_fields(tmp_path, pack,
                                                      monkeypatch, flag,
                                                      attr, calibrate):
    """``run.py --serve 0 --serve_int8[_trunk] N`` calibrates the served
    backend on the first min(N, test fields) fields drawn with
    ``default_rng(0)``, as JAX ``run.py`` does: the same quantized tensors
    as calibrating by hand, scales within 1e-5 of JAX's calibration of its
    own generator on those fields, and the exact path's other part off."""
    captured = {}

    def fake_serve(backend, **kw):
        captured.update(kw, backend=backend)
        return "served"

    monkeypatch.setattr(server, "serve", fake_serve)
    assert _cli(tmp_path, pack, "--serve", "0", flag, "5") == "served"
    backend = captured["backend"]
    q = getattr(backend, attr)
    assert q is not None
    assert getattr(backend, "qtrunk" if attr == "qhead" else "qhead") is None
    cfg = _cfg(True, tmp_path, pack)
    _, ds_test, _, _, _ = preprocess(cfg, synthetic=True,
                                     synthetic_hours=HOURS,
                                     synthetic_size=SIZE)
    assert len(ds_test) < 5  # min(N, len(ds_test)) fields
    rng = np.random.default_rng(0)
    fields = np.stack([ds_test.get(i, rng)[0] for i in range(len(ds_test))])
    want = WindFieldSR.from_continuation(cfg, pack, device="cpu")
    getattr(want, calibrate)(fields)
    wq = getattr(want, attr)
    names = ("s_in", "wq_main", "s_main") if attr == "qhead" else (
        "s_x", "s_c", "wq_lff", "sw_lff")
    for name in names:
        assert torch.equal(getattr(q, name), getattr(wq, name)), name
    jsr = JaxSR(JaxGAN(tiny_cfg(False), COORDS, COORDS),
                jax_load_continuation(pack)["params_G_ema"])
    jq_ = getattr(jsr, calibrate)(fields)
    scale = "s_in" if attr == "qhead" else "s_c"
    assert _rel(getattr(q, scale).numpy(), np.asarray(getattr(jq_, scale))
                ) <= 1e-5
    lr = (np.random.default_rng(1).standard_normal((2, 4, 4, 4, 4))
          * 0.3).astype(np.float32)
    z = np.random.default_rng(2).standard_normal(
        (2, 16, 16, 4, 1)).astype(np.float32)
    assert _rel(backend.upscale(lr, z), np.asarray(jsr.upscale(lr, z))
                ) <= 1e-4
