"""PyTorch port's model axis (``parallel/model.py``): the sharding rule
against JAX's ``_param_spec`` leaf by leaf, and on four gloo ranks (one
spawn for the module, ``tests/_torch_dp_worker.py``) the meshes with a
model axis and their groups, the Megatron pair and its backward, every
conv shape of G with its output channels over the model axis against the
whole conv, ``shard_state`` → ``gather_state`` bit for bit, the rounding
draws of a sharded bf16 moment, int8 serving refused on a model mesh, and
the port on data 2 × model 2 against itself in one process with every
draw on; in this process, a sharded state refused where a whole one is
needed.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.parallel import make_mesh, shard_params
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.models.blocks import ConvLReLU
from gan_sr_wind_field_tpu_torch.parallel.model import sharded_keys
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    _torch_key,
    params_from_jax,
)

W = 4
CONVS = {
    "k3": dict(in_channels=8, features=8),
    "k5 hr_conv0": dict(in_channels=8, features=12, kernel_size=5,
                        padding=2, lrelu=False),
    "lff 1x1x1 with bias": dict(in_channels=16, features=8, kernel_size=1,
                                padding=0, lrelu=False, use_bias=True),
    "horizontal": dict(in_channels=8, features=8, conv_mode="horizontal_3D",
                       z_in=4),
}


def _inputs():
    rng = np.random.default_rng(19)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cfg_sr = tiny_cfg(True, optimizer_state_dtype="bfloat16_sr",
                      g_ema_decay=0.999)
    cfg = tiny_cfg(True, dropout=0.1, use_instance_noise=True,
                   use_noisy_labels=True, g_ema_decay=0.999)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    st = gan.init_state(3, LR_SHAPE, HR_SHAPE)
    pvp = dict(cfg=cfg, coords=COORDS, axes=(2, 2),
               state=dict(params_G=st.params_G, params_D=st.params_D,
                          batch_stats_D=st.batch_stats_D, it=1,
                          lr_shape=LR_SHAPE, hr_shape=HR_SHAPE),
               traj=[make_batch(30 + i, n=4) for i in range(4)])
    conv_x = {n: a(2, 6, 6, 4, kw["in_channels"]) for n, kw in CONVS.items()}
    conv_w = {}
    for n, kw in CONVS.items():
        y = ConvLReLU(**kw)(torch.from_numpy(conv_x[n]))
        conv_w[n] = a(*y.shape)
    return dict(pair_x=a(5, 6), pair_w=a(6, 8), pair_c=a(5, 8),
                convs=CONVS, conv_x=conv_x, conv_w=conv_w, cfg_sr=cfg_sr,
                coords=COORDS, lr_shape=LR_SHAPE, hr_shape=HR_SHAPE,
                moment=a(8, 4, 3, 3, 3), calib_lr=a(2, 4, 4, 4, 4),
                pvp=pvp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    p = _inputs()
    return p, spawn("model_units", W, tmp_path_factory.mktemp("model"), p)


@pytest.mark.parametrize("conv_mode", ["3D", "horizontal_3D"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_leaves_are_jaxs_model_specs(conv_mode, tp):
    """Leaf by leaf, the port shards exactly the leaves of G that JAX's
    shard_params gives a 'model' spec on make_mesh(2, tp): in 3D the conv
    kernels and biases whose outputs divide tp (not hr_conv1's 3), in
    horizontal_3D the LFFs only (the 6-D kernels stay whole)."""
    cfg = tiny_cfg(False)
    cfg.gan_config.conv_mode = conv_mode
    gan = JaxGAN(cfg, COORDS, COORDS)
    params = gan.init_state(jax.random.key(0), LR_SHAPE,
                            HR_SHAPE).params_G
    placed = shard_params(params, make_mesh(2, tp))
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        if "model" in leaf.sharding.spec:
            want.add(_torch_key(tuple(k.key for k in path)))
    port = params_from_jax(jax.tree.map(np.asarray, params))
    got = sharded_keys(port, tp)
    assert got == want
    assert "hr_conv1.weight" not in got
    if conv_mode == "3D":
        assert {"feature_conv.weight", "hr_conv0_x.weight",
                "rrdbs.0.rdbs.0.lff.bias"} <= got
    else:
        assert all(".lff." in k for k in got) and got


def test_model_meshes_and_their_groups(ranks):
    """make_mesh(2, 2): JAX's row-major order (rank r is data row r // 2,
    model index r % 2), the model group the two ranks of a row, the group
    of a model index its data rows, the world group every rank, one lead;
    make_mesh(-1, 2) takes world // 2 rows; make_mesh(1, 2) leaves ranks
    2 and 3 idle."""
    _, res = ranks
    for r, v in enumerate(res["units"]):
        (shape, names, d, m, world, n, lead, group, data, model,
         everyone) = v["m22"]
        assert (shape, names) == ({"data": 2, "model": 2}, ("data", "model"))
        assert (d, m, world, n, lead) == (r // 2, r % 2, 2, 4, r == 0)
        assert group == data == [r % 2, r % 2 + 2]
        assert model == [r - r % 2, r - r % 2 + 1]
        assert everyone == [0, 1, 2, 3]
        assert v["m-1x2"] == {"data": 2, "model": 2}
        assert v["spare"] == ((True, {"data": 1, "model": 2}, None)
                              if r >= 2 else (False, {"data": 1, "model": 2},
                                              r))


def test_pair_forward_and_backward(ranks):
    """A channel map x @ W with W's columns over the model axis: the
    gathered output is x @ W on every rank, x's gradient the whole one
    (the identity's backward sums the two ranks' parts), and W's columns
    get their slice of the whole gradient (the gather's backward keeps it),
    as one process computes them."""
    p, res = ranks
    x = torch.from_numpy(p["pair_x"]).requires_grad_()
    w = torch.from_numpy(p["pair_w"]).requires_grad_()
    y = x @ w
    (y * torch.from_numpy(p["pair_c"])).sum().backward()
    for v in res["units"]:
        m = v["rank"] % 2
        got_y, got_gx, got_gw = v["pair"]
        torch.testing.assert_close(got_y, y.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_gx, x.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_gw, w.grad[:, 4 * m:4 * m + 4],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CONVS))
def test_sharded_conv_equals_the_whole_conv(ranks, name):
    """Each conv shape of G with its output channels over two model ranks
    (k3, the k5 head conv, the 1³ LFF with its bias, and the horizontal
    conv cut on its O axis): the output, the input's gradient and the
    weight's and bias's gradients, gathered, equal the whole conv's."""
    p, res = ranks
    conv = ConvLReLU(**CONVS[name], generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(p["conv_x"][name]).requires_grad_()
    y = conv(x)
    (y * torch.from_numpy(p["conv_w"][name])).sum().backward()
    for v in res["units"]:
        got_y, got_gx, got_g = v[f"conv {name}"]
        torch.testing.assert_close(got_y, y.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_gx, x.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_g["weight"], conv.weight.grad,
                                   rtol=1e-5, atol=1e-5)
        if conv.bias is not None:
            torch.testing.assert_close(got_g["bias"], conv.bias.grad,
                                       rtol=1e-5, atol=1e-5)


def test_shard_then_gather_is_the_whole_state(ranks):
    """shard_state cuts G's parameters, EMA and Adam moments (bf16 here)
    to each rank's output channels and leaves hr_conv1 whole;
    gather_state gives every tensor back bit for bit."""
    _, res = ranks
    for v in res["units"]:
        keys, fc, hr1 = v["sharded"]
        assert "feature_conv.weight" in keys and \
            "hr_conv1.weight" not in keys
        assert fc == (4, 4, 3, 3, 3) and hr1 == (3, 12, 3, 3, 3)
        assert v["round_trip"] == (True, [])


def test_int8_serving_on_a_model_mesh_raises(ranks):
    """``WindFieldSR(mesh=)`` on data 2 × model 2 refuses both int8
    calibrations, as JAX's ``WindFieldSR`` refuses int8 off the
    single-device path (eval/serve.py:150-156)."""
    _, res = ranks
    for v in res["units"]:
        for name in ("quantize", "quantize_trunk"):
            assert "model/spatial mesh" in v[name], (name, v[name])


@pytest.mark.parametrize("where", ["train_step", "generate",
                                   "save_checkpoint", "pack_from_state"])
def test_a_sharded_state_is_refused_where_a_whole_one_is_needed(
        tmp_path, where):
    """A state whose G holds one rank's channels (``state.sharded``) is
    refused, naming gather_state, by a trainer without a model axis and by
    the checkpoint and pack writers: a checkpoint is the one-process
    format."""
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
    from gan_sr_wind_field_tpu_torch.train.continuation import (
        pack_from_state,
    )

    gan = WindFieldGAN(tiny_cfg(True), COORDS, COORDS, device="cpu")
    state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    state.sharded = frozenset({"feature_conv.weight"})
    lr, hr, z = make_batch(3)
    with pytest.raises(ValueError, match="gather_state"):
        if where == "train_step":
            gan.train_step(state, lr, hr, z)
        elif where == "generate":
            gan.generate(state, lr, z)
        elif where == "save_checkpoint":
            ckpt.save_checkpoint(str(tmp_path), state)
        else:
            pack_from_state(str(tmp_path / "p.npz"), state)


def test_sharded_moment_draws_its_bits_whole(ranks):
    """A stochastically rounded moment of this rank's channels draws its
    bits at the whole leaf's shape and keeps its channels: the one-process
    rounding's slice, bit for bit, so a model mesh draws what one process
    draws."""
    _, res = ranks
    assert all(v["sr"] for v in res["units"])


def test_model_mesh_equals_one_process_with_every_draw(ranks):
    """Instance noise, noisy labels, G and D dropout and augmentation on,
    data 2 × model 2 against one process on the global batches from one
    state and one generator state (tests/test_torch_parallel_step.py's
    check): a validation batch, one G step's losses and gradients, one D
    step's, then four steps, within 1e-5 relative (D's zero-sum bias to
    1e-6 absolute, its biases after the steps to 2·lr per D step); the
    generator ends in the same state and every rank's whole state is the
    same bit for bit."""
    _, res = ranks
    got = res["pvp"]
    assert got["same_on_every_rank"] and got["same_rng"]
    errs = dict(got["errs"])
    assert errs.pop("D grad fc1.bias abs") <= 1e-6
    bad = {k: v for k, v in errs.items() if not v <= 1e-5}
    assert not bad, bad
    assert got["bias_diff"] <= 2 * 1e-3 * 2
