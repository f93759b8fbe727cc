"""Shared set-up of the PyTorch port's training tests: the tiny
configuration of ``tests/test_train_step.py:tiny_cfg`` with the fused trunk
and the stencil kernels on, built for the JAX package and for the port,
and seeded numpy batches."""

import numpy as np

from gan_sr_wind_field_tpu.config import Config as JaxConfig
from gan_sr_wind_field_tpu_torch.config import Config as PortConfig

LR_SHAPE = (2, 4, 4, 4, 4)
HR_SHAPE = (2, 16, 16, 4, 3)
COORDS = np.arange(16, dtype=np.float32) * 150


def tiny_cfg(port: bool, num_rdb_convs: int = 2, dropout: float = 0.0,
             **training):
    """``tests/test_train_step.py:tiny_cfg`` with use_fused_trunk and
    use_pallas_stencil on, remat off (so the JAX G step takes its fused
    trunk), G and D dropout at ``dropout``, instance noise off, and
    ``training`` overrides."""
    cfg = (PortConfig if port else JaxConfig)()
    cfg.scale = 4
    cfg.compute_dtype = "float32"
    cfg.use_fused_trunk = True
    cfg.use_pallas_stencil = True
    g = cfg.gan_config
    g.include_pressure = False
    g.include_z_channel = True
    g.number_of_z_layers = 4
    g.enable_slicing = True
    g.slice_size = 16
    G = cfg.generator
    G.num_features = 8
    G.num_RRDB = 1
    G.num_RDB_convs = num_rdb_convs
    G.RDB_growth_chan = 4
    G.hr_kern_size = 3
    G.terrain_number_of_features = 4
    G.dropout_probability = dropout
    G.use_remat = False
    cfg.discriminator.num_features = 4
    cfg.discriminator.dropout_probability = dropout
    t = cfg.training
    t.niter = 100
    t.d_g_train_period = 2
    t.d_g_train_ratio = 1
    t.learning_rate_g = 1e-3
    t.learning_rate_d = 1e-3
    t.multistep_lr_steps = [10, 20]
    t.use_instance_noise = False
    t.use_one_sided_label_smoothing = True
    t.adversarial_loss_weight = 5e-4
    t.gradient_z_loss_weight = 0.1
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


def make_batch(seed: int, n: int = 2, size: int = 16, zl: int = 4,
               scale: int = 4):
    """(lr, hr, z) float32 numpy: smooth HR winds, decimated LR plus a
    height channel, a terrain-following cumulative-sum Z."""
    rng = np.random.default_rng(seed)
    xx = np.linspace(0, 2 * np.pi, size)
    grid = np.add.outer(xx, 0.5 * xx)[None, :, :, None, None]
    phases = rng.uniform(0, 6.28, (n, 1, 1, 1, 3))
    zz = np.linspace(0, 1, zl)[None, None, None, :, None]
    hr = (0.5 * np.sin(grid + phases) * (0.5 + zz)
          + 0.1 * rng.standard_normal((n, size, size, zl, 3)))
    hr = hr.astype(np.float32)
    lr = np.concatenate(
        [hr[:, ::scale, ::scale],
         rng.random((n, size // scale, size // scale, zl, 1))], axis=-1,
    ).astype(np.float32)
    z = np.cumsum(1.0 + rng.random((n, size, size, zl, 1)), axis=3) * 10
    return lr, hr, z.astype(np.float32)
