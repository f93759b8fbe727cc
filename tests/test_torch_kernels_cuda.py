"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Imports nothing of JAX, so it runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Each test skips where there is no card.
"""

import pytest
import torch
import torch.nn.functional as F

from _torch_head_geoms import HEAD_GEOMS
from _torch_int8_geoms import (
    INT8_GEOMS,
    PAIR_GEOMS,
    REQUANT_GEOMS,
    pair_inputs,
    requant_inputs,
)
from _torch_stencil_geoms import STENCIL_GEOMS
from _torch_trunk_geoms import TC_GEOMS
from gan_sr_wind_field_tpu_torch.models.blocks import RRDB
from gan_sr_wind_field_tpu_torch.models.fused_train import TrainableTrunk
from gan_sr_wind_field_tpu_torch.ops import conv_int8 as int8_mod
from gan_sr_wind_field_tpu_torch.ops import hr_head as head_mod
from gan_sr_wind_field_tpu_torch.ops import rdb_trunk, stencil
from gan_sr_wind_field_tpu_torch.ops.hr_head import (
    hr_head,
    hr_head_conv,
    hr_head_conv_reference,
    pack_head_weights,
    plan_head_tc,
)
from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    pack_trunk_weights_bwd,
    rrdb_trunk,
    rrdb_trunk_bwd,
    rrdb_trunk_bwd_reference,
    rrdb_trunk_reference,
)
from gan_sr_wind_field_tpu_torch.utils import spans


@pytest.fixture
def cuda_device():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("nf,gc,num_convs,shape", [
    (8, 4, 3, (2, 4, 3, 5)),      # channels below one 32-wide slice
    (40, 12, 5, (1, 5, 3, 7)),    # slices straddling the state/growth split
    (128, 32, 5, (2, 16, 16, 10)),  # the served geometry
    # the full volumes of the 8x and 16x configurations at batch 8
    (128, 32, 5, (8, 16, 16, 10)),
    (128, 32, 5, (8, 8, 8, 10)),
])
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch, dtype,
                                              tol, nf, gc, num_convs, shape):
    # the plain version is the float32 yardstick: no TF32 in its convs
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(nf + gc)
    rrdbs = [RRDB(nf, gc, num_convs=num_convs, init_scale=1.0,
                  generator=gen) for _ in range(2)]
    for r in rrdbs:
        for rdb in r.rdbs:
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(*shape, nf, generator=gen)
    packed = pack_trunk_weights(rrdbs, dtype, cuda_device)
    x_d = x.to(cuda_device, dtype)
    before = rdb_trunk.launches
    got = rrdb_trunk(packed, x_d, gc=gc, num_convs=num_convs)
    torch.cuda.synchronize()
    assert rdb_trunk.launches == before + 1
    want = rrdb_trunk_reference(
        pack_trunk_weights(rrdbs, torch.float32, cuda_device),
        x_d.float(), gc=gc, num_convs=num_convs,
    )
    inc, inc_ref = (got.float() - x_d.float()), (want - x_d.float())
    err = (torch.linalg.vector_norm(inc - inc_ref)
           / torch.linalg.vector_norm(inc_ref)).item()
    assert err <= tol, err


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def _trunk_setup(nf, gc, num_convs, shape, seed, device):
    gen = torch.Generator().manual_seed(seed)
    rrdbs = [RRDB(nf, gc, num_convs=num_convs, init_scale=1.0,
                  generator=gen) for _ in range(2)]
    for r in rrdbs:
        for rdb in r.rdbs:
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(*shape, nf, generator=gen).to(device)
    d_out = torch.randn(*shape, nf, generator=gen).to(device)
    return rrdbs, x, d_out


TRUNK_GEOMS = [
    (8, 4, 3, (2, 4, 3, 5)),
    (40, 12, 5, (1, 5, 3, 7)),
    (128, 32, 5, (2, 16, 16, 10)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("nf,gc,num_convs,shape", TRUNK_GEOMS)
def test_residual_mode_matches_plain_version_on_card(
        cuda_device, monkeypatch, dtype, tol, nf, gc, num_convs, shape):
    """out, states and growths of the residual mode against
    rrdb_trunk_reference(with_residuals=True) on the same inputs, in the
    same dtype (the rounding points are the same; the sums' order is
    not)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rrdbs, x, _ = _trunk_setup(nf, gc, num_convs, shape, nf + gc + 1,
                               cuda_device)
    packed = pack_trunk_weights(rrdbs, dtype, cuda_device)
    x = x.to(dtype)
    before = rdb_trunk.launches
    got = rrdb_trunk(packed, x, gc=gc, num_convs=num_convs,
                     with_residuals=True)
    torch.cuda.synchronize()
    assert rdb_trunk.launches == before + 1
    want = rrdb_trunk_reference(packed, x, gc=gc, num_convs=num_convs,
                                with_residuals=True)
    assert _rel(got[0].float() - x.float(), want[0].float() - x.float()) \
        <= tol
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g.float(), w.float()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("nf,gc,num_convs,shape", TRUNK_GEOMS)
def test_backward_kernel_matches_plain_version_on_card(
        cuda_device, monkeypatch, dtype, tol, nf, gc, num_convs, shape):
    """d_x, dU and dLFF of the backward kernel against
    rrdb_trunk_bwd_reference on the same growths and cotangent."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rrdbs, x, d_out = _trunk_setup(nf, gc, num_convs, shape, nf + gc + 2,
                                   cuda_device)
    packed = pack_trunk_weights(rrdbs, dtype, cuda_device)
    _, _, growths = rrdb_trunk_reference(
        packed, x.to(dtype), gc=gc, num_convs=num_convs, with_residuals=True)
    packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                      num_convs=num_convs)
    d_out = d_out.to(dtype)
    before = rdb_trunk.bwd_launches
    got = rrdb_trunk_bwd(packed_t, growths, d_out, gc=gc,
                         num_convs=num_convs)
    torch.cuda.synchronize()
    assert rdb_trunk.bwd_launches == before + 1
    want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, gc=gc,
                                    num_convs=num_convs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g.float(), w.float()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["serving", "residual", "backward"])
@pytest.mark.parametrize("nf,gc,num_convs,shape,vec", TC_GEOMS)
def test_tensor_core_tile_edges_on_card(cuda_device, monkeypatch, mode, nf,
                                        gc, num_convs, shape, vec):
    """bf16 on the tensor cores against the bf16 plain version (3e-2) at
    geometries at the tile's edges: the forward without and with
    residuals, and the backward on the plain version's growths."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dt = torch.bfloat16
    rrdbs, x, d_out = _trunk_setup(nf, gc, num_convs, shape, nf + gc + 4,
                                   cuda_device)
    packed = pack_trunk_weights(rrdbs, dt, cuda_device)
    x, d_out = x.to(dt), d_out.to(dt)
    kw = dict(gc=gc, num_convs=num_convs)
    assert rdb_trunk.plan_trunk_tc(shape, nf, gc, num_convs)["vec"] == vec
    before = (rdb_trunk.launches, rdb_trunk.bwd_launches)
    if mode == "backward":
        _, _, growths = rrdb_trunk_reference(packed, x, with_residuals=True,
                                             **kw)
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=num_convs)
        got = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **kw)
        rose = (0, 1)
    else:
        res = mode == "residual"
        got = rrdb_trunk(packed, x, with_residuals=res, **kw)
        want = rrdb_trunk_reference(packed, x, with_residuals=res, **kw)
        got, want = ([got], [want]) if not res else (list(got), list(want))
        got[0], want[0] = got[0] - x, want[0] - x  # the increment
        rose = (1, 0)
    torch.cuda.synchronize()
    assert (rdb_trunk.launches - before[0],
            rdb_trunk.bwd_launches - before[1]) == rose
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dt
        assert torch.isfinite(g).all()
        assert _rel(g.float(), w.float()) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Z", [2, 7, 10, 64])
def test_tc_plan_counts_the_kernels_shared_memory(cuda_device, Z):
    """plan_trunk_tc's shared-memory bytes are what the kernels launch
    with (both libraries report their tiles' bytes)."""
    import ctypes

    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fwd = load_library("rdb_trunk").windsr_rrdb_trunk_tc_smem
    bwd = load_library("rdb_trunk_bwd").windsr_rrdb_trunk_bwd_tc_smem
    fwd.restype = bwd.restype = ctypes.c_longlong
    for gc in (4, 32, 48):
        plan = rdb_trunk.plan_trunk_tc((1, 4, 4, Z), 128, gc, 5)["convs"]
        assert fwd(0, Z, 128 + 3 * gc) == plan["fwd_growth"]["smem"]
        assert fwd(1, Z, 128 + 4 * gc) == plan["fwd_lff"]["smem"]
        assert bwd(0, Z, gc) == plan["bwd_growth"]["smem"]
        assert bwd(1, Z, 128) == plan["bwd_lff"]["smem"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STENCIL_GEOMS)
def test_stencil_kernels_match_plain_versions_on_card(cuda_device, shape):
    """Gradient and adjoint against their plain versions (1e-5: the same
    arithmetic, only fused multiply-adds differ), and the adjoint
    identity <L u, g> = <u, L^T g> to 1e-5 relative."""
    N, X, Y, Zl = shape
    gen = torch.Generator().manual_seed(sum(shape))
    uvw = torch.randn(N, X, Y, Zl, 3, generator=gen)
    g9 = torch.randn(N, X, Y, Zl, 9, generator=gen)
    x = torch.cumsum(torch.rand(X, generator=gen) + 0.5, 0)
    y = torch.cumsum(torch.rand(Y, generator=gen) + 0.5, 0)
    Z = torch.cumsum(torch.rand(N, X, Y, Zl, 1, generator=gen) + 0.05, 3)
    uvw, g9, x, y, Z = (t.to(cuda_device) for t in (uvw, g9, x, y, Z))
    b_f, b_a = stencil.launches, stencil.adjoint_launches
    grad = stencil.wind_gradient(uvw, x, y, Z)
    adj = stencil.wind_gradient_adjoint(g9, x, y, Z)
    torch.cuda.synchronize()
    assert (stencil.launches, stencil.adjoint_launches) == (b_f + 1, b_a + 1)
    assert _rel(grad, wind_field_gradient(uvw, x, y, Z)) <= 1e-5
    assert _rel(adj, stencil.wind_gradient_adjoint_reference(g9, x, y, Z)) \
        <= 1e-5
    lhs = (grad.double() * g9.double()).sum().item()
    rhs = (uvw.double() * adj.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
@pytest.mark.parametrize("Zl", [2, 10, 33, 52])
def test_stencil_plan_counts_the_kernels_shared_memory(cuda_device, Zl):
    """plan_stencil's shared-memory bytes are what the kernels launch with
    (the library reports its tiles' bytes), where the plan has a tile."""
    import ctypes

    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = load_library("stencil").windsr_stencil_smem
    fn.restype = ctypes.c_longlong
    for adjoint in (False, True):
        try:
            plan = stencil.plan_stencil((1, 4, 4, Zl), adjoint)
        except ValueError:
            continue
        assert fn(int(adjoint), Zl) == plan["smem"]


@pytest.mark.cuda
def test_stencil_kernels_refuse_a_too_deep_volume(cuda_device):
    """Far past the plan's deepest Zl the tiles' columns do not fit a
    block's shared memory: both wrappers raise before they launch."""
    shape = (1, 3, 3, 400)
    uvw = torch.randn(*shape, 3, device=cuda_device)
    g9 = torch.randn(*shape, 9, device=cuda_device)
    x = torch.arange(3.0, device=cuda_device)
    Z = torch.cumsum(torch.ones(*shape, 1, device=cuda_device), 3)
    before = (stencil.launches, stencil.adjoint_launches)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.wind_gradient(uvw, x, x, Z)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.wind_gradient_adjoint(g9, x, x, Z)
    assert (stencil.launches, stencil.adjoint_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc,num_convs,shape", TRUNK_GEOMS[:2])
def test_trainable_trunk_grads_match_autograd_on_card(
        cuda_device, monkeypatch, nf, gc, num_convs, shape):
    """TrainableTrunk (both trunk kernels and the cuDNN dW stage) against
    torch.autograd through the plain trunk, float32, TF32 off: 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rrdbs, x, tgt = _trunk_setup(nf, gc, num_convs, shape, nf + gc + 3,
                                 cuda_device)
    geom = dict(gc=gc, num_convs=num_convs, rdb_scale=0.2, rrdb_scale=0.2,
                negative_slope=0.2)
    grads = []
    for kernel in (True, False):
        packed = {k: v.clone().requires_grad_() for k, v in
                  pack_trunk_weights(rrdbs, torch.float32,
                                     cuda_device).items()}
        xv = x.clone().requires_grad_()
        if kernel:
            out = TrainableTrunk.apply(packed["conv"], packed["lff"],
                                       packed["bias"], xv, geom)
        else:
            out = rrdb_trunk_reference(packed, xv, **geom)
        (out * tgt).sum().backward()
        grads.append([packed["conv"].grad, packed["lff"].grad,
                      packed["bias"].grad, xv.grad])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def _head_setup(nf, tc, C, k, shape, masked, device, seed):
    gen = torch.Generator().manual_seed(seed)
    wx = torch.randn(C, nf, k, k, k, generator=gen) * (2 / (nf * k ** 3)) ** .5
    wt = torch.randn(C, tc, k, k, k, generator=gen) * (2 / (tc * k ** 3)) ** .5
    x = torch.randn(*shape, nf, generator=gen)
    t = torch.randn(*shape, tc, generator=gen)
    dm = None
    if masked:  # about 10 % of the channels dropped, the rest scaled
        dm = torch.where(torch.rand(shape[0], C, generator=gen) < 0.9,
                         1 / 0.9, 0.0)
    return [None if v is None else v.to(device)
            for v in (wx, wt, x, t, dm)]




@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nf,tc,C,shape,vec", HEAD_GEOMS)
def test_hr_head_kernel_matches_plain_version_on_card(
        cuda_device, monkeypatch, dtype, tol, masked, k, nf, tc, C, shape,
        vec):
    """The HR-head kernel against hr_head_conv_reference on the same
    inputs in the same dtype: both sum in float32 and round once, so only
    the order of the sums differs. bf16 runs on the tensor-core tile with
    copies of `vec` channels."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    wx, wt, x, t, dm = _head_setup(nf, tc, C, k, shape, masked, cuda_device,
                                   nf + C + k)
    packed = pack_head_weights(wx, wt, dtype, cuda_device)
    x, t = x.to(dtype), t.to(dtype)
    dm = None if dm is None else dm.to(dtype)
    assert plan_head_tc(x.shape, nf, tc, C, k)["vec"] == vec
    before = head_mod.launches
    got = hr_head_conv(packed, x, t, dm, k=k, negative_slope=0.2)
    torch.cuda.synchronize()
    assert head_mod.launches == before + 1
    want = hr_head_conv_reference(packed, x, t, dm, k=k, negative_slope=0.2)
    assert got.shape == want.shape == (*shape, C) and got.dtype == dtype
    assert _rel(got.float(), want.float()) <= tol
    if masked:
        assert (got[(dm == 0)[:, None, None, None, :].expand_as(got)]
                == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Z", [2, 9, 10, 64, 118])
def test_head_plan_counts_the_kernels_shared_memory(cuda_device, Z):
    """plan_head_tc's shared-memory bytes are what the bf16 head kernel
    launches with (the library reports its tiles' bytes)."""
    import ctypes

    from gan_sr_wind_field_tpu_torch.ops.kernels.build import load_library

    fn = load_library("hr_head").windsr_hr_head_tc_smem
    fn.restype = ctypes.c_longlong
    for k in (3, 5):
        assert fn(k, Z) == plan_head_tc((1, 4, 4, Z), 128, 16, 144,
                                        k)["smem"]


@pytest.mark.cuda
def test_hr_head_kernel_refuses_a_too_deep_volume(cuda_device):
    """Past Zl = 118 the k = 5 tile's windows do not fit a block's shared
    memory: the wrapper raises before it launches."""
    wx, wt, x, t, _ = _head_setup(8, 8, 16, 5, (1, 1, 1, 119), False,
                                  cuda_device, 3)
    packed = pack_head_weights(wx, wt, torch.bfloat16, cuda_device)
    before = head_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        hr_head_conv(packed, x.bfloat16(), t.bfloat16(), k=5)
    assert head_mod.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_hr_head_grads_match_autograd_on_card(cuda_device, monkeypatch,
                                              masked):
    """HRHead's four gradients against autograd of the plain head,
    float32, TF32 off: 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    wx, wt, x, t, dm = _head_setup(24, 16, 24, 5, (2, 6, 5, 4), masked,
                                   cuda_device, 7 + masked)
    cot = torch.randn(2, 6, 5, 4, 24, device=cuda_device)
    grads = []
    for kernel in (True, False):
        leaves = [v.clone().requires_grad_() for v in (wx, wt, x, t)]
        if kernel:
            h = hr_head(*leaves, dm, k=5, negative_slope=0.2)
        else:
            pre = (F.conv3d(leaves[2].permute(0, 4, 1, 2, 3), leaves[0],
                            padding=2)
                   + F.conv3d(leaves[3].permute(0, 4, 1, 2, 3), leaves[1],
                              padding=2))
            h = F.leaky_relu(pre, 0.2).permute(0, 2, 3, 4, 1)
            if dm is not None:
                h = h * dm[:, None, None, None, :]
        (h * cot).sum().backward()
        grads.append([v.grad for v in leaves])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def _graph_cfg(head: bool):
    """The tiny training configuration of ``tests/_torch_tiny.py`` (the
    fused trunk and the stencils on), with dropout, instance noise, grad
    clipping and an EMA, built without JAX; with ``head`` the HR-head
    kernel in every G forward."""
    from gan_sr_wind_field_tpu_torch.config import Config

    cfg = Config()
    cfg.scale = 4
    cfg.compute_dtype = "float32"
    cfg.use_fused_trunk = True
    cfg.use_pallas_stencil = True
    cfg.use_pallas_head = head
    g = cfg.gan_config
    g.include_pressure = False
    g.include_z_channel = True
    g.number_of_z_layers = 4
    g.enable_slicing = True
    g.slice_size = 16
    G = cfg.generator
    G.num_features, G.num_RRDB, G.num_RDB_convs = 8, 1, 3
    G.RDB_growth_chan, G.hr_kern_size = 4, 3
    G.terrain_number_of_features = 4
    G.dropout_probability = 0.1
    cfg.discriminator.num_features = 4
    cfg.discriminator.dropout_probability = 0.1
    t = cfg.training
    t.niter, t.d_g_train_period, t.d_g_train_ratio = 100, 2, 1
    t.learning_rate_g = t.learning_rate_d = 1e-3
    t.use_instance_noise = True
    t.use_one_sided_label_smoothing = True
    t.use_grad_clipping = True
    t.g_ema_decay = 0.999
    return cfg


def _clone_state(state):
    from gan_sr_wind_field_tpu_torch.train.gan import AdamState

    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    trees = {t: None if getattr(state, t) is None
             else {k: v.clone() for k, v in getattr(state, t).items()}
             for t in ("params_G", "params_D", "batch_stats_D",
                       "params_D_frozen", "params_G_ema")}
    opts = {o: AdamState(getattr(state, o).count.clone(),
                         {k: v.clone() for k, v in getattr(state, o).mu.items()},
                         {k: v.clone() for k, v in getattr(state, o).nu.items()})
            for o in ("opt_state_G", "opt_state_D")}
    return type(state)(**trees, **opts, it=state.it, rng=rng)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True])
def test_captured_steps_equal_eager_steps_on_card(cuda_device, monkeypatch,
                                                  head):
    """``train_chunk`` over six iterations (G, D, D, G, G, D: each kind
    warmed up and captured on its first use, then replayed, 4 replays)
    against six eager ``train_step``s on the same batches, float32 with
    cuDNN's deterministic algorithms and no TF32 (else two eager runs
    differ too): every tree, the generator's state and the metrics equal,
    and each graph's launches those of one eager step of its kind."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    from gan_sr_wind_field_tpu_torch.train.step_graphs import launch_counts

    coords = torch.arange(32, dtype=torch.float32) * 150
    gan = WindFieldGAN(_graph_cfg(head), coords[:16], coords[:16],
                       device=cuda_device)
    state = gan.init_state(0, (2, 4, 4, 4, 4), (2, 16, 16, 4, 3))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    full = torch.rand((3, 32, 32, 4, 4), generator=gen, device=cuda_device)
    zraw = torch.cumsum(1.0 + torch.rand((3, 32, 32, 4, 1), generator=gen,
                                         device=cuda_device), dim=3) * 10
    kw = dict(batch_size=2, patch=16, patch_y=16, cf=4, enable_slicing=True)
    eager = _clone_state(state)
    before = launch_counts()
    state, metrics = gan.train_chunk(state, full, zraw, 5, n_steps=6,
                                     augment=True, **kw)
    torch.cuda.synchronize()
    chunk_launches = tuple(a - b for a, b in zip(launch_counts(), before))
    graphs = gan._graphs
    assert graphs.replays == 4 and sorted(graphs.graphs) == [False, True]
    per_step = {}
    for _ in range(6):
        kind = gan.is_g_step(eager.it + 1)
        c0 = launch_counts()
        eager, want = gan.train_step(
            eager, *batch_at(full, zraw, 5, eager.it, **kw), augment=True)
        per_step[kind] = tuple(a - b for a, b in zip(launch_counts(), c0))
    torch.cuda.synchronize()
    for kind, (_, _, captured) in graphs.graphs.items():
        assert captured == per_step[kind], kind
    assert chunk_launches == tuple(3 * g + 3 * d for g, d in
                                   zip(per_step[True], per_step[False]))
    assert per_step[True][:4] == (1, 1, 2, 1)
    assert per_step[True][4] == per_step[False][4] == int(head)
    assert state.it == eager.it == 6
    assert torch.equal(state.rng.get_state(), eager.rng.get_state())
    pairs = [(f"{t}/{k}", v, getattr(eager, t)[k])
             for t in ("params_G", "params_D", "batch_stats_D",
                       "params_G_ema") for k, v in getattr(state, t).items()]
    for o in ("opt_state_G", "opt_state_D"):
        mine, theirs = getattr(state, o), getattr(eager, o)
        pairs.append((f"{o}.count", mine.count, theirs.count))
        pairs += [(f"{o}.{m}/{k}", v, getattr(theirs, m)[k])
                  for m in ("mu", "nu") for k, v in getattr(mine, m).items()]
    pairs += [(f"metrics/{k}", v, want[k]) for k, v in metrics.items()]
    differ = [(n, _rel(a, b)) for n, a, b in pairs if not torch.equal(a, b)]
    assert differ == []


def _int8_call(geom, device, seed):
    """Seeded int8 inputs and weights in [-127, 127], positive float32
    scales and, where the geometry has one, a bias, on ``device``."""
    N, X, Y, Z, ci, co, k, pad, bias = geom
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (N, X, Y, Z, ci), generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (*k, ci, co), generator=gen,
                       dtype=torch.int8)
    s = torch.rand(co, generator=gen) * 1e-3 + 1e-5
    b = torch.randn(co, generator=gen) if bias else None
    return [None if v is None else v.to(device) for v in (xq, wq, s, b)], pad


@pytest.mark.cuda
@pytest.mark.parametrize("geom", INT8_GEOMS)
def test_conv_int8_kernel_matches_plain_version_on_card(cuda_device, geom):
    """Bit for bit: the int32 sums are exact on both sides, and the
    epilogue rounds float(acc) * s, then + b, once each."""
    (xq, wq, s, b), pad = _int8_call(geom, cuda_device, sum(geom[:6]))
    before = int8_mod.launches
    got = int8_mod.conv3d_int8(xq, wq, pad, s, b)
    torch.cuda.synchronize()
    assert int8_mod.launches == before + 1
    want = int8_mod.conv3d_int8_reference(xq, wq, pad, s, b)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    # a packed weight given by the caller gives the same
    again = int8_mod.conv3d_int8(xq, wq, pad, s, b,
                                 packed=int8_mod.pack_conv_int8(wq))
    assert torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", PAIR_GEOMS)
def test_head_pair_int8_kernel_matches_plain_version_on_card(cuda_device,
                                                             geom,
                                                             out_dtype):
    """One launch for both convs, bit for bit: the main conv's columns
    rounded once to the output's dtype, the remainder's float32 partials."""
    xq, wm, sm, wr, sr = (None if v is None else v.to(cuda_device)
                          for v in pair_inputs(geom, sum(geom)))
    k, cm, cr = geom[7], geom[5], geom[6]
    p = (k - 1) // 2
    width = cm + 16
    before = int8_mod.pair_launches
    out, partial = int8_mod.head_pair_int8(xq, wm, sm, p, wr, sr,
                                           width=width, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_mod.pair_launches == before + 1
    want, want_partial = int8_mod.head_pair_int8_reference(
        xq, wm, sm, p, wr, sr, width=width, out_dtype=out_dtype)
    assert out.shape == want.shape and out.dtype == out_dtype
    assert torch.equal(out[..., :cm], want[..., :cm])
    if cr:
        assert partial.dtype == torch.float32
        assert torch.equal(partial, want_partial)
    else:
        assert partial is None and want_partial is None


@pytest.mark.cuda
@pytest.mark.parametrize("geom", REQUANT_GEOMS)
def test_conv_int8_requant_kernel_matches_plain_version_on_card(cuda_device,
                                                                geom):
    """One launch, bit for bit: the conv of the first ci channels, its
    LeakyReLU and quantize_act written at the column offset, every other
    byte of the output as it was."""
    N, X, Y, Z, ci, co, ldx, ldo, col, same, k = geom
    buf, wq, s, sc, out = (v.to(cuda_device)
                           for v in requant_inputs(geom, sum(geom[:9])))
    if same:
        out = buf
    p = (k - 1) // 2
    want = int8_mod.conv3d_int8_requant_reference(
        buf.clone(), ci, wq, p, s, sc, 0.2,
        buf.clone() if same else out.clone(), col)
    before = int8_mod.requant_launches
    got = int8_mod.conv3d_int8_requant(buf, ci, wq, p, s, sc, 0.2, out, col,
                                       packed=int8_mod.pack_conv_int8(wq))
    torch.cuda.synchronize()
    assert int8_mod.requant_launches == before + 1 and got is out
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_int8_plan_counts_the_kernels_shared_memory(cuda_device):
    """The plans' shared memory is the library's own count, for every tile
    at the card tests' and the served geometries."""
    calls = [(g[3], g[6], g[7]) for g in INT8_GEOMS] + [
        (10, (5, 5, 5), (2, 2, 2)), (10, (1, 1, 5), (0, 0, 2)),
        (10, (3, 3, 3), (1, 1, 1)), (10, (1, 1, 1), (0, 0, 0))]
    for tile in int8_mod.TILES:
        for Z, k, pad in calls:
            assert int8_mod.kernel_smem(tile, Z, k, pad) == tile.smem_bytes(
                Z, k, pad), (tile, Z, k)
    plan = int8_mod.plan_head_pair_int8((8, 64, 64, 10), 128, 128, 400,
                                        (5, 5, 5), 2)
    assert plan["smem"] == max(
        int8_mod.kernel_smem(int8_mod.HEAD_TILE, 10, (5, 5, 5), 2),
        int8_mod.kernel_smem(int8_mod.REM_TILE, 10, (1, 1, 5), (0, 0, 2)))


@pytest.mark.cuda
def test_conv_int8_kernel_refuses_what_it_does_not_take(cuda_device):
    (xq, wq, s, _), _ = _int8_call(INT8_GEOMS[1], cuda_device, 7)
    with pytest.raises(ValueError, match="keeps the extent"):
        int8_mod.conv3d_int8(xq, wq, 0, s)
    with pytest.raises(ValueError, match="int8"):
        int8_mod.conv3d_int8(xq.float(), wq, 1, s)
    with pytest.raises(ValueError, match="packed"):
        int8_mod.conv3d_int8(xq, wq, 1, s, packed=wq.contiguous())


@pytest.mark.cuda
def test_conv_int8_requant_refuses_a_pitch_or_offset(cuda_device):
    """The requantizing wrapper raises, before any launch, for an input
    pitch or ci that is not a multiple of 16, output columns past the
    output's pitch, and columns that overlap the input channels of the
    same buffer."""
    gen = torch.Generator().manual_seed(9)
    wq = torch.randint(-127, 128, (3, 3, 3, 32, 8), generator=gen,
                       dtype=torch.int8).to(cuda_device)
    s = torch.full((8,), 1e-3, device=cuda_device)
    buf = torch.zeros((1, 4, 4, 4, 64), dtype=torch.int8, device=cuda_device)
    odd = torch.zeros((1, 4, 4, 4, 40), dtype=torch.int8, device=cuda_device)
    before = int8_mod.requant_launches
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_mod.conv3d_int8_requant(odd, 32, wq, 1, s, s, 0.2, buf, 32)
    with pytest.raises(ValueError, match="do not fit"):
        int8_mod.conv3d_int8_requant(buf, 32, wq, 1, s, s, 0.2, buf, 60)
    with pytest.raises(ValueError, match="overlap"):
        int8_mod.conv3d_int8_requant(buf, 32, wq, 1, s, s, 0.2, buf, 24)
    with pytest.raises(ValueError, match="contiguous"):
        int8_mod.conv3d_int8_requant(buf[..., :48], 32, wq, 1, s, s, 0.2,
                                     buf, 48)
    assert int8_mod.requant_launches == before


@pytest.mark.cuda
def test_device_span_times_forward_and_backward_on_the_stream(cuda_device):
    """A device span records one event pair around its body and one
    around the backward of what it wraps, and none while the stream
    captures a CUDA graph."""
    spans.enable()
    spans.clear()
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        x, w = (torch.randn(2048, 2048, device=cuda_device, generator=gen,
                            requires_grad=True) for _ in range(2))
        (x @ w).sum().backward()  # cuBLAS's set-up, outside the span
        with spans.device_span("s") as s:
            (u,) = s.inputs(x)
            y = s.output(u @ w)
        y.sum().backward()
        (got,) = spans.read(names=("s",))
        assert len(spans._ring[-1].events) == 2
        # three 2048^3 products at well under the card's peak
        assert 0.0 < got.device_ms < 100.0, got.device_ms
        static = torch.zeros(1024, device=cuda_device)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            static.add_(1.0)  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            with spans.device_span("captured"):
                static.add_(1.0)
        graph.replay()
        (cap,) = spans.read(names=("captured",))
        assert cap.device_ms is None
        assert float(static[0]) == 2.0
    finally:
        spans.enable(False)
        spans.clear()
