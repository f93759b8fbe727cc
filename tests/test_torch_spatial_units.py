"""PyTorch port's spatial axis, unit by unit, on 4 gloo ranks on the CPU
(``tests/_torch_dp_worker.py``, one spawn for the module): the meshes
``make_mesh(2, 1, 2)`` and ``(-1, 1, 4)`` and their three groups; on data
1 × spatial 4 the halo exchange (zeros at the volume's ends) and its
backward, every conv shape the models use on a slab against the whole
conv (3³ padding 1, 5³ padding 2, D's (4, 4, 3) stride (2, 2, 1), the
horizontal conv in both, the 1³ LFF with its bias), an RDB whose convs
each take their own halo, the plain stencil pair
on haloed slabs against the whole volume, the align-corners resize of the
validation baseline, batch norm over the mesh, instance norm over the slabs
and ``gather_x`` with its reduce-scatter backward, each against one process
on the whole tensor; then the port on data 2 × spatial 2 against itself in
one process with every draw on (dropout, instance noise, noisy labels,
augmentation). Last, the ``ValueError`` for an x extent that does not
divide.

Each rank's loss is its own slab's weighted sum, so the whole tensor's
reference loss is the sum over the ranks' windows of the same weights.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu_torch.models.blocks import (
    RDB,
    BatchNorm,
    ConvLReLU,
    instance_norm,
)
from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy
from gan_sr_wind_field_tpu_torch.parallel import Mesh, Slab
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from test_torch_parallel_step import ZERO_SUM_ATOL

W = 4
CONVS = {
    "k3 p1": dict(in_channels=3, features=4, kernel_size=3, padding=1),
    "k5 p2": dict(in_channels=3, features=4, kernel_size=5, padding=2),
    "(4, 4, 3) stride (2, 2, 1)": dict(in_channels=3, features=4,
                                       kernel_size=(4, 4, 3), padding=1,
                                       strides=(2, 2, 1)),
    "horizontal k3 p1": dict(in_channels=3, features=4, kernel_size=3,
                             padding=1, conv_mode="horizontal_3D", z_in=4),
    "horizontal (4, 4, 3) stride (2, 2, 1)": dict(
        in_channels=3, features=4, kernel_size=(4, 4, 3), padding=1,
        strides=(2, 2, 1), conv_mode="horizontal_3D", z_in=4),
    "LFF 1³ with bias": dict(in_channels=3, features=4, kernel_size=1,
                             padding=0, lrelu=False, use_bias=True),
}


def _conv(name):
    return ConvLReLU(**CONVS[name], generator=torch.Generator().manual_seed(3))


def _inputs():
    rng = np.random.default_rng(17)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    conv_x = f32(2, 16, 8, 4, 3)
    conv_w = {name: f32(*_conv(name)(torch.from_numpy(conv_x)).shape)
              for name in CONVS}
    xc = np.cumsum(100 + 50 * rng.random(16)).astype(np.float32)
    yc = np.cumsum(100 + 50 * rng.random(8)).astype(np.float32)
    z = np.cumsum(1.0 + rng.random((2, 16, 8, 4, 1)), axis=3) * 10
    pvp_cfg = tiny_cfg(True, dropout=0.1, use_instance_noise=True,
                       use_noisy_labels=True, g_ema_decay=0.999)
    gan = WindFieldGAN(pvp_cfg, COORDS, COORDS, device="cpu")
    st = gan.init_state(3, LR_SHAPE, HR_SHAPE)
    return dict(
        x=f32(2, 8, 3, 2, 2), convs=CONVS,
        rdb_x=f32(2, 16, 8, 4, 8), rdb_w=f32(2, 16, 8, 4, 8),
        w_halo={h: f32(W, 2, 2 + 2 * h, 3, 2, 2) for h in (1, 2)},
        w_gather=f32(W, 2, 8, 3, 2, 2),
        conv_x=conv_x, conv_w=conv_w,
        uvw=f32(2, 16, 8, 4, 3), Z=z.astype(np.float32), xc=xc, yc=yc,
        w9=f32(2, 16, 8, 4, 9), lr=f32(2, 8, 4, 2, 3),
        bn_x=f32(2, 8, 3, 2, 5, scale=2.0) + 1, bn_w=f32(2, 8, 3, 2, 5),
        pvp=dict(cfg=pvp_cfg, coords=COORDS, axes=(2, 1, 2), state=dict(
            params_G=st.params_G, params_D=st.params_D,
            batch_stats_D=st.batch_stats_D, it=1, lr_shape=LR_SHAPE,
            hr_shape=HR_SHAPE),
            traj=[make_batch(20 + i, n=4) for i in range(4)]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    p = _inputs()
    return p, spawn("spatial_units", W, tmp_path_factory.mktemp("sp_units"),
                    p)


def _cat(res, key, i):
    return torch.cat([v[key][i] for v in res["units"]], dim=1)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


def test_meshes_and_their_groups(ranks):
    """make_mesh(2, 1, 2): the three axes, data-major ranks (rank r is row
    r // 2, slab r % 2), rank 0 alone the lead, the data group (one slab's
    ranks) and the spatial group (one row's), the mesh's world, and
    volume_sharding's rows then slab; make_mesh(1, 1, 2) leaves ranks 2
    and 3 idle; make_mesh(-1, 1, 4) takes every rank on one row."""
    _, res = ranks
    for r, v in enumerate(res["units"]):
        shape, names, d, s, world, lead, (dg, sg), whole, cut = v["m22"]
        assert shape == {"data": 2, "model": 1, "spatial": 2}
        assert names == ("data", "model", "spatial")
        assert (d, s, world, lead) == (r // 2, r % 2, 4, r == 0)
        assert dg == [r % 2, r % 2 + 2] and sg == [r - r % 2, r - r % 2 + 1]
        assert whole == [0, 1, 2, 3]
        rows = np.arange(32).reshape(4, 8)[2 * d:2 * d + 2]
        assert cut == rows[:, 4 * s:4 * s + 4].tolist()
        assert v["spare"] == ((r >= 2), {"data": 1, "model": 1,
                                         "spatial": 2},
                              None if r >= 2 else r)
        shape, d, s, (dg, sg) = v["m14"]
        assert shape["spatial"] == 4 and (d, s) == (0, r)
        assert dg == [r] and sg == [0, 1, 2, 3]


@pytest.mark.parametrize("width", [1, 2])
def test_halo_exchange_and_its_backward(ranks, width):
    """Each rank's slab widened by ``width`` planes of its neighbours is
    the zero-padded volume's window; the gradient, with every halo plane's
    cotangent returned to the rank that sent it, is the whole volume's."""
    p, res = ranks
    x = _leaf(p["x"])
    padded = F.pad(x, (0, 0) * 3 + (width, width))
    loss = sum((padded[:, 2 * r:2 * r + 2 + 2 * width]
                * torch.from_numpy(p["w_halo"][width][r])).sum()
               for r in range(W))
    loss.backward()
    for r, v in enumerate(res["units"]):
        torch.testing.assert_close(
            v[f"halo{width}"][0],
            padded[:, 2 * r:2 * r + 2 + 2 * width].detach(), rtol=0, atol=0)
    assert torch.equal(res["units"][0][f"halo{width}"][0][:, :width],
                       torch.zeros_like(x[:, :width]))
    torch.testing.assert_close(_cat(res, f"halo{width}", 1), x.grad,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_on_slabs_equals_the_whole_conv(ranks, name):
    """The conv on 4 slabs with their x halos: the outputs side by side,
    the input's gradient and the weight's gradient summed over the ranks
    equal the conv of the whole volume's."""
    p, res = ranks
    conv = _conv(name)
    x = _leaf(p["conv_x"])
    y = conv(x)
    (y * torch.from_numpy(p["conv_w"][name])).sum().backward()
    key = f"conv {name}"
    torch.testing.assert_close(_cat(res, key, 0), y.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(_cat(res, key, 1), x.grad, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(sum(v[key][2] for v in res["units"]),
                               conv.weight.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lff", [1, 3])
def test_rdb_on_slabs_equals_the_whole_rdb(ranks, lff):
    """An RDB of 5 convs on slabs of 4 planes, each conv taking its own
    halo, with a 1³ LFF (no halo) and with a 3³ one. The output, the
    input's gradient and a growth conv's weight gradient summed over the
    ranks equal the whole RDB's."""
    p, res = ranks
    rdb = RDB(8, 4, num_convs=5, lff_kern_size=lff,
              generator=torch.Generator().manual_seed(5))
    x = _leaf(p["rdb_x"])
    y = rdb(x)
    (y * torch.from_numpy(p["rdb_w"])).sum().backward()
    key = f"rdb lff {lff}"
    torch.testing.assert_close(_cat(res, key, 0), y.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(_cat(res, key, 1), x.grad, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(sum(v[key][2] for v in res["units"]),
                               rdb.convs[1].weight.grad, rtol=1e-5,
                               atol=1e-5)


def test_stencil_on_haloed_slabs_equals_the_whole_volume(ranks):
    """The plain gradient stencil on slabs widened by one neighbour plane
    (one-sided only at the volume's ends) and its adjoint through the halo
    against the whole volume's, on a nonuniform grid with terrain-following
    heights."""
    p, res = ranks
    uvw = _leaf(p["uvw"])
    g9 = wind_field_gradient(uvw, torch.from_numpy(p["xc"]),
                             torch.from_numpy(p["yc"]),
                             torch.from_numpy(p["Z"]))
    (g9 * torch.from_numpy(p["w9"])).sum().backward()
    torch.testing.assert_close(_cat(res, "stencil", 0), g9.detach(),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(_cat(res, "stencil", 1), uvw.grad,
                               rtol=1e-5, atol=1e-6)


def test_trilinear_baseline_on_slabs(ranks):
    """The validation's align-corners baseline on LR slabs of 2 planes,
    each with one neighbour plane: the HR slabs side by side are the whole
    resize, bit for bit."""
    p, res = ranks
    want = upsample_trilinear_xy(torch.from_numpy(p["lr"]), 4)
    got = torch.cat([v["trilinear"] for v in res["units"]], dim=1)
    assert torch.equal(got, want)


def test_batch_norm_over_the_mesh(ranks):
    """Train-mode batch norm over every rank's slab: the output, the
    input's gradient, the scale's gradient summed over the ranks and the
    moved running statistics equal one process's on the whole tensor."""
    p, res = ranks
    bn = BatchNorm(5)
    x = _leaf(p["bn_x"])
    y = bn(x, train=True, update_stats=True)
    (y * torch.from_numpy(p["bn_w"])).sum().backward()
    torch.testing.assert_close(_cat(res, "bn", 0), y.detach(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(_cat(res, "bn", 1), x.grad, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(sum(v["bn"][2] for v in res["units"]),
                               bn.scale.grad, rtol=1e-4, atol=1e-5)
    for v in res["units"]:
        torch.testing.assert_close(v["bn"][3], bn.mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v["bn"][4], bn.var, rtol=1e-5, atol=1e-6)


def test_instance_norm_over_the_slabs(ranks):
    """Each sample's moments summed over its slabs: the output and the
    input's gradient equal the whole tensor's."""
    p, res = ranks
    x = _leaf(p["bn_x"])
    y = instance_norm(x, torch.float32)
    (y * torch.from_numpy(p["bn_w"])).sum().backward()
    torch.testing.assert_close(_cat(res, "instance", 0), y.detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(_cat(res, "instance", 1), x.grad, rtol=1e-4,
                               atol=1e-5)


def test_gather_x_and_its_reduce_scatter(ranks):
    """Every rank gets the whole x extent, bit for bit; each slab's
    gradient is the sum of every rank's cotangent of its planes."""
    p, res = ranks
    wsum = p["w_gather"].sum(axis=0)
    for r, v in enumerate(res["units"]):
        assert torch.equal(v["gather"][0], torch.from_numpy(p["x"]))
        torch.testing.assert_close(v["gather"][1],
                                   torch.from_numpy(wsum[:, 2 * r:2 * r + 2]),
                                   rtol=1e-6, atol=1e-6)


def test_spatial_mesh_equals_one_process_with_every_draw(ranks):
    """Data 2 × spatial 2 with instance noise (drawn at the global batch's
    whole shape, cut to rows and slab), noisy labels, G and D dropout (one
    mask per row and channel on both slabs) and augmentation (on the rows
    whole, the slab cut after): a validation batch, one G step's losses
    and gradients and one D step's loss, gradients and moved statistics
    within 1e-5 relative (each tensor's L2; D's last bias, a near-zero sum,
    to 1e-6 absolute); then four steps, whose G and EMA stay within 1e-5
    and D within 1e-5 but for its biases (2·lr per D step,
    tests/test_torch_parallel_step.py); the generator ends in the same
    state, and every rank's state is the same bit for bit."""
    _, res = ranks
    got = res["pvp"]
    assert got["same_on_every_rank"] and got["same_rng"]
    errs = dict(got["errs"])
    assert errs.pop("D grad fc1.bias abs") <= ZERO_SUM_ATOL
    bad = {k: v for k, v in errs.items() if not v <= 1e-5}
    assert not bad, bad
    assert got["bias_diff"] <= 2 * 1e-3 * 2  # two D steps


def test_an_x_extent_that_does_not_divide_raises():
    """GSPMD would pad; the port raises instead (ROADMAP.md §3): an LR x
    extent of 4 over a spatial axis of 3, and a slab cut of 10 planes over
    4."""
    mesh = Mesh(None, None, None, 1, 0, 3, 0)
    with pytest.raises(ValueError, match="does not divide over a spatial"):
        WindFieldGAN(tiny_cfg(True), COORDS, COORDS, device="cpu",
                     mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        Slab(None, 0, 4).cut(torch.zeros(1, 10, 2))
