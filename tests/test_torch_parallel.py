"""PyTorch port's ``parallel/``: ``make_mesh`` (mirroring
tests/test_parallel.py's mesh tests), the collectives' values and
gradients, batch norm and the physics factors over a group, the placement
helpers, and the rule that decides which meshes ``train_chunk`` can
capture. The group is 4 gloo ranks on the CPU (``_torch_dp_worker.py``,
one spawn for the module) or, for the rule, this process alone.

Each rank's loss in these checks is the same replicated value, so the
group's loss is that value times the ranks, and each gradient is checked
against that: the factor is the trap ``parallel/collectives.py`` names.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, tiny_cfg
from gan_sr_wind_field_tpu_torch.config import Config
from gan_sr_wind_field_tpu_torch.models.blocks import BatchNorm
from gan_sr_wind_field_tpu_torch.ops.physics import gradient_norm_factors
from gan_sr_wind_field_tpu_torch.parallel import (
    init_distributed,
    make_mesh,
    pad_batch_to,
    shard_params,
)
from gan_sr_wind_field_tpu_torch.parallel.mesh import data_axis
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.step_graphs import capturable

W = 4
WEIGHTS = (0.5, 1.5, 2.0)


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((W, 3, 2)).astype(np.float32)
    # the maximum 5.0 held three times: twice on rank 0, once on rank 2
    x[0, 0, 0] = x[0, 2, 1] = x[2, 1, 0] = 5.0
    return dict(
        x=x, w=WEIGHTS,
        bn_x=rng.standard_normal((8, 3, 3, 2, 5)).astype(np.float32) * 2
        + 1,
        bn_w=rng.standard_normal((8, 3, 3, 2, 5)).astype(np.float32),
        sr=rng.standard_normal((4, 6, 6, 4, 9)).astype(np.float32),
        hr=rng.standard_normal((4, 6, 6, 4, 9)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    p = _inputs()
    return p, spawn("units", W, tmp_path_factory.mktemp("units"), p)


def test_mesh_shapes(ranks):
    """The axes ('data', 'model'), -1 taking every rank, each rank's
    index and rows, and the placement of a batch on it."""
    _, res = ranks
    for r, v in enumerate(res):
        size, rank, shape, names, rows = v["mesh"]
        assert (size, rank, shape, names) == (W, r, {"data": W, "model": 1},
                                              ("data", "model"))
        assert rows == slice(2 * r, 2 * r + 2)
        # batch_sharding / volume_sharding: this rank's rows
        assert v["sharding"] == [[2 * r, 2 * r + 1], [r]]


def test_spare_ranks_are_idle(ranks):
    """A data axis of 2 over 4 ranks takes ranks 0 and 1; 2 and 3 are idle,
    as JAX's spare chips are."""
    _, res = ranks
    assert [v["spare"][:3] for v in res] == [(False, 2, 0), (False, 2, 1),
                                            (True, 2, None),
                                            (True, 2, None)]


def test_model_and_spatial_axes_raise():
    """The model axis is ported (tests/test_torch_model_*.py) and is built
    like the data and spatial axes: without a process group a mesh with a
    model axis, with or without a spatial axis beside it, asks for one;
    data_axis takes world // (tp·s) rows for data_parallel = -1 and names
    --nproc_per_node for a mesh of more ranks than run; without a model
    axis the placement of G's parameters is the identity. make_mesh(-1, 2)
    takes world // 2 rows on 4 ranks in test_model_meshes_and_their_groups
    (tests/test_torch_model_units.py)."""
    for axes in ((4, 2), (2, 2, 4), (2, 1, 4)):
        with pytest.raises(RuntimeError, match="init_distributed"):
            make_mesh(*axes)
    par = dataclasses.replace(Config().parallel, data_parallel=-1,
                              tensor_parallel=2)
    assert data_axis(par, 8, 8) == (4, 2, 1)
    with pytest.raises(ValueError, match="nproc_per_node=2"):
        data_axis(par, 1, 8)
    params = {"a": torch.ones(2)}
    assert shard_params(params, None) is params


def test_group_sum_and_mean(ranks):
    p, res = ranks
    x = p["x"]
    for v in res:
        s, gs = v["sum"]
        np.testing.assert_allclose(s, x.sum(), rtol=1e-6)
        torch.testing.assert_close(gs, torch.full((3, 2), W * WEIGHTS[0]))
        m, gm = v["mean"]
        np.testing.assert_allclose(m, x.mean(), rtol=1e-6)
        torch.testing.assert_close(
            gm, torch.full((3, 2), W * WEIGHTS[2] / x.size))


def test_group_amax_splits_global_ties(ranks):
    """The maximum over every rank; its gradient reaches only the three
    maximal entries, on ranks 0 and 2, a third each, as torch.amax of the
    whole tensor gives."""
    p, res = ranks
    full = torch.from_numpy(p["x"]).requires_grad_()
    (torch.amax(full) * W * WEIGHTS[1]).backward()
    assert (full.grad != 0).sum() == 3
    for r, v in enumerate(res):
        m, g = v["amax"]
        assert m == 5.0
        torch.testing.assert_close(g, full.grad[r])


def test_flat_all_reduce_and_gather(ranks):
    p, res = ranks
    for v in res:
        a, b, c = v["flat"]
        torch.testing.assert_close(a, torch.full((3,), 6.0))
        torch.testing.assert_close(b, torch.full((2, 2), 4.0))
        assert c.dtype == torch.int64 and c.tolist() == [6, 6]
        torch.testing.assert_close(v["gather"],
                                   torch.from_numpy(p["x"].reshape(W * 3, 2)))


def test_batch_norm_over_the_group(ranks):
    """Train-mode batch norm with the group's statistics: the output, the
    input's gradient, the scale's gradient summed over the ranks and the
    moved running statistics equal one process's on the whole batch."""
    p, res = ranks
    bn = BatchNorm(5)
    x = torch.from_numpy(p["bn_x"]).requires_grad_()
    y = bn(x, train=True, update_stats=True)
    (y * torch.from_numpy(p["bn_w"])).sum().backward()
    got_y = torch.cat([v["bn"][0] for v in res])
    got_gx = torch.cat([v["bn"][1] for v in res])
    torch.testing.assert_close(got_y, y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_gx, x.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(v["bn"][2] for v in res), bn.scale.grad,
                               rtol=1e-4, atol=1e-5)
    for v in res:
        torch.testing.assert_close(v["bn"][3], bn.mean, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(v["bn"][4], bn.var, rtol=1e-5, atol=1e-6)


def test_physics_factors_over_the_group(ranks):
    p, res = ranks
    sr = torch.from_numpy(p["sr"]).requires_grad_()
    f = gradient_norm_factors(torch.from_numpy(p["hr"]), sr)
    (sum(f) * W).backward()
    got = torch.cat([v["factors"][1] for v in res])
    for v in res:
        np.testing.assert_allclose(v["factors"][0], [t.item() for t in f],
                                   rtol=1e-6)
    torch.testing.assert_close(got, sr.grad)


def test_replicate_takes_the_first_rank(ranks):
    _, res = ranks
    for v in res:
        a, b = v["replicate"]
        assert a.tolist() == [0.0] * 4 and b.tolist() == [0, 0]


def test_pad_batch_to():
    """As JAX's (tests/test_parallel.py:125)."""
    b = np.arange(5 * 2).reshape(5, 2).astype(np.float32)
    padded, n = pad_batch_to(b, 4)
    assert padded.shape == (8, 2) and n == 5
    np.testing.assert_array_equal(padded[:5], b)
    np.testing.assert_array_equal(padded[5:], np.repeat(b[:1], 3, axis=0))
    same, n2 = pad_batch_to(b[:4], 4)
    assert same.shape == (4, 2) and n2 == 4


@pytest.fixture
def gloo_world_of_one(tmp_path):
    init_distributed("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1, timeout_s=60)
    try:
        yield make_mesh(-1)
    finally:
        dist.destroy_process_group()


def test_train_chunk_refuses_a_gloo_group_on_the_card(gloo_world_of_one):
    """CUDA graphs capture NCCL's all_reduce but not gloo's (checked on the
    card, train/step_graphs.py): the rule ``capturable`` applies says so,
    and train_chunk on a card with a gloo group raises before it touches
    the card."""
    mesh = gloo_world_of_one
    assert capturable(None) and not capturable(mesh)
    gan = WindFieldGAN(tiny_cfg(True), COORDS, COORDS, device="cpu",
                       mesh=mesh)
    state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    gan.device = torch.device("cuda")
    with pytest.raises(ValueError, match="gloo"):
        gan.train_chunk(state, None, None, 0, n_steps=2, batch_size=2,
                        patch=16, patch_y=16, cf=4, enable_slicing=False)
