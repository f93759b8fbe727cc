"""PyTorch port: the JAX package's config-space corners
(``tests/test_config_space.py:40-62``) on the port, from JAX's initial
state: channel makeup, scale, HR kernel size, the LFF kernel,
``horizontal_3D`` with plain ReLU, and the dropout corner's geometry. Each
builds in both packages and takes one G and one D step, each from JAX's
state before it: the port's G total matches JAX's within 2e-6 relative and
its D loss within 1e-6 relative; the SR keeps the HR geometry. (Measured
on the CPU: the D losses 0 to 4.2e-7 apart, a few float32 ulps of a loss
of 0.70 after a batch norm over 4–8 values in D's last layers.)

Dropout and instance noise are off on both sides (the two packages draw
different random numbers), and so are the trunk and stencil kernels, as in
the JAX test.
"""

import jax
import numpy as np
import pytest

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

SIZE, ZL = 16, 4
COORDS = np.arange(SIZE, dtype=np.float32) * 150

# tests/test_config_space.py:CASES, dropout_probability left out (off here)
CASES = {
    "min_channels_scale2_k1": dict(
        scale=2, include_pressure=False, include_z_channel=False,
        hr_kern_size=1,
    ),
    "all_channels_scale8": dict(
        scale=8, include_pressure=True, include_z_channel=True,
        include_above_ground_channel=True, hr_kern_size=3,
    ),
    "lff3": dict(scale=4, lff_kern_size=3),
    "horizontal_relu": dict(
        scale=4, conv_mode="horizontal_3D", act_type="relu",
    ),
    "dropout_head": dict(scale=4, hr_kern_size=3),
}


def corner_cfg(port: bool, c: dict):
    """``tests/test_config_space.py``'s configuration of corner ``c`` for
    either package, with dropout, instance noise and the kernels off."""
    cfg = tiny_cfg(port)
    cfg.use_fused_trunk = False
    cfg.use_pallas_stencil = False
    cfg.scale = c["scale"]
    g = cfg.gan_config
    g.include_pressure = c.get("include_pressure", False)
    g.include_z_channel = c.get("include_z_channel", True)
    g.include_above_ground_channel = c.get("include_above_ground_channel",
                                           False)
    g.conv_mode = c.get("conv_mode", "3D")
    gen = cfg.generator
    gen.hr_kern_size = c.get("hr_kern_size", 3)
    gen.lff_kern_size = c.get("lff_kern_size", 1)
    gen.act_type = c.get("act_type", "leakyrelu")
    return cfg


def _batch(scale: int, n_lr_ch: int, n: int = 2):
    """``tests/test_config_space.py:_batch`` from the seed 0, in numpy."""
    rng = np.random.default_rng(0)
    hr = rng.standard_normal((n, SIZE, SIZE, ZL, 3)).astype(np.float32) * 0.3
    lr = hr[:, ::scale, ::scale]
    if n_lr_ch > 3:
        extra = rng.random((n, SIZE // scale, SIZE // scale, ZL,
                            n_lr_ch - 3)).astype(np.float32)
        lr = np.concatenate([lr, extra], axis=-1)
    z = np.cumsum(1.0 + rng.random((n, SIZE, SIZE, ZL, 1)).astype(
        np.float32), axis=3) * 10
    return lr, hr, z


@pytest.mark.parametrize("name", sorted(CASES))
def test_corner_matches_jax(name):
    c = CASES[name]
    jcfg, cfg = corner_cfg(False, c), corner_cfg(True, c)
    lr, hr, z = _batch(c["scale"], cfg.lr_num_channels)
    jgan = JaxGAN(jcfg, COORDS, COORDS)
    jstate = jgan.init_state(jax.random.key(0), lr.shape, hr.shape)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    state = gan.state_from_jax(jstate, hr.shape)
    assert gan.G.conv_mode == cfg.gan_config.conv_mode
    assert gan.G.negative_slope == jgan.G.negative_slope
    # period 2, ratio 1: it 1 is a G step, it 2 a D step; each step of
    # the port starts from JAX's state before it (D's Adam state is still
    # the fresh one there, as state_from_jax makes it)
    for key, rtol in (("total", 2e-6), ("D_train_loss", 1e-6)):
        if key == "D_train_loss":
            state = gan.state_from_jax(jstate, hr.shape)
        jstate, mj = jgan.train_step(jstate, lr, hr, z)
        state, mp = gan.train_step(state, lr, hr, z)
        assert int(mp["is_g_step"]) == int(mj["is_g_step"])
        assert np.isfinite(float(mp[key])), name
        np.testing.assert_allclose(float(mp[key]), float(mj[key]),
                                   rtol=rtol, err_msg=name)
    sr = gan.generate(state, lr, z)
    assert tuple(sr.shape) == hr.shape, name
    assert bool(sr.isfinite().all()), name
