"""PyTorch port: ``conv_mode = "horizontal_3D"`` and D's instance norm
against the JAX package on the CPU, in float32, at the tiny geometry of
``tests/_torch_tiny.py``: the per-window conv at the cases of
``tests/test_horizontal_conv.py``, its init, flax's instance norm, the
models through the weight bridge both ways, one G and one D step, and every
entry point that reads or writes a horizontal generator (pack, checkpoint,
export, serving, chunks, ``.pth``, the command line).

Inputs are numpy seeds; both packages start from JAX's initial state.
Dropout, instance noise and noisy labels are off, as the two packages draw
different random numbers.
"""

import dataclasses
import io
import json
import threading
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.models import Discriminator3D as JaxD
from gan_sr_wind_field_tpu.models.blocks import HorizontalConv3D
from gan_sr_wind_field_tpu.train.continuation import (
    load_continuation as jax_load_continuation,
)
from gan_sr_wind_field_tpu.train.continuation import (
    save_continuation as jax_save_continuation,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.utils.torch_import import (
    import_discriminator_state_dict as jax_import_d,
)
from gan_sr_wind_field_tpu_torch.eval import server
from gan_sr_wind_field_tpu_torch.eval.export import (
    export_generator,
    load_exported,
)
from gan_sr_wind_field_tpu_torch.eval.interp import blend_params
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR, _tiling
from gan_sr_wind_field_tpu_torch.models.blocks import (
    ConvLReLU,
    horizontal_conv3d_cl,
    instance_norm,
)
from gan_sr_wind_field_tpu_torch.models.discriminator import Discriminator3D
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.continuation import (
    load_continuation,
    pack_from_state,
)
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils import torch_import
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    d_params_to_jax,
    params_from_jax,
    params_to_jax,
)

H = "horizontal_3D"
TREES = ("params_G", "params_D", "batch_stats_D", "params_G_ema")
COORDS32 = np.arange(32, dtype=np.float32) * 150


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def h_cfg(port: bool, norm: str = "instance", slicing: bool = True,
          **training):
    """The tiny configuration with ``[GAN] conv_mode = horizontal_3D`` and
    D's ``norm_type``; without slicing the HR batch is the 32×32 domain."""
    cfg = tiny_cfg(port, **training)
    cfg.gan_config.conv_mode = H
    cfg.discriminator.norm_type = norm
    cfg.gan_config.enable_slicing = slicing
    return cfg


def _shapes(slicing: bool):
    if slicing:
        return LR_SHAPE, HR_SHAPE, COORDS
    return (2, 8, 8, 4, 4), (2, 32, 32, 4, 3), COORDS32


def _batch(seed: int, slicing: bool = True):
    return make_batch(seed, size=16 if slicing else 32)


@pytest.fixture(scope="module")
def jax_h():
    """JAX's horizontal GAN (instance-norm D, slicing on) and its initial
    state."""
    gan = JaxGAN(h_cfg(False), COORDS, COORDS)
    return gan, gan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)


def _port(jstate, slicing=True, **kw):
    _, hr_shape, coords = _shapes(slicing)
    gan = WindFieldGAN(h_cfg(True, slicing=slicing, **kw), coords, coords,
                       device="cpu")
    return gan, gan.state_from_jax(jstate, hr_shape)


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("k,s,p", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),   # kz, pz, sz = 3, 1, 1
    ((3, 3, 3), (1, 1, 2), (1, 1, 1)),   # 3, 1, 2
    ((3, 3, 1), (1, 1, 1), (1, 1, 0)),   # 1, 0, 1
    ((4, 4, 3), (2, 2, 1), (1, 1, 1)),   # D's strided conv: xy stride 2
])
def test_horizontal_conv_matches_jax(k, s, p):
    """The port's grouped-conv2d form against JAX's vmapped windows, on
    JAX's kernel through the bridge's 6-D transpose: ≤ 1e-5 relative L2."""
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 6, 3)).astype(
        np.float32)
    mod = HorizontalConv3D(features=5, kernel_size=k, strides=s, padding=p)
    kernel = np.asarray(mod.init(jax.random.key(1), x)["params"]["kernel"])
    want = np.asarray(mod.apply({"params": {"kernel": kernel}}, x))
    w = d_params_from_jax({"c": {"hconv": {"kernel": kernel}}})["c.weight"]
    assert w.shape == (kernel.shape[0], 5, 3, *k)
    got = horizontal_conv3d_cl(torch.from_numpy(x), w, p, s).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= 1e-5


def test_horizontal_init_std_follows_jax_fan_in():
    """flax's variance_scaling reads the whole 6-D kernel: fan-in
    W·kh·kw·kz·Cin, std 0.00761 for W=10, k=3, Cin=128 (not the per-window
    0.0241). The port's draw and JAX's, within 3 %."""
    conv = ConvLReLU(128, 32, z_in=10, conv_mode=H,
                     generator=torch.Generator().manual_seed(0))
    assert conv.weight.shape == (10, 32, 128, 3, 3, 3)
    want = np.sqrt(2.0 / (10 * 27 * 128))
    mod = HorizontalConv3D(features=32, kernel_size=3, padding=(1, 1, 1))
    jk = mod.init(jax.random.key(0), jnp.zeros((1, 4, 4, 10, 128)))
    for std in (conv.weight.std().item(),
                float(np.std(jk["params"]["kernel"]))):
        assert abs(std / want - 1) < 0.03, std


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_flax_group_norm(dtype):
    """flax GroupNorm(group_size=1, no affine, eps 1e-5) as JAX's
    ConvLReLU builds it; bf16 to one bf16 rounding."""
    x = (np.random.default_rng(1).standard_normal((2, 6, 5, 4, 7)) * 3
         + 1).astype(np.float32)
    jdt = jnp.dtype(dtype)
    gn = fnn.GroupNorm(num_groups=None, group_size=1, epsilon=1e-5,
                       use_bias=False, use_scale=False, dtype=jdt)
    xj = jnp.asarray(x, jdt)
    want = np.asarray(gn.apply(gn.init(jax.random.key(0), xj), xj),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = instance_norm(torch.from_numpy(x).to(tdt), tdt)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module")
def jax_h_flat():
    """The same GAN without slicing: the HR batch is the 32×32 domain and
    the instance-norm D has no statistics at all."""
    lr_shape, hr_shape, coords = _shapes(False)
    gan = JaxGAN(h_cfg(False, slicing=False), coords, coords)
    return gan, gan.init_state(jax.random.key(0), lr_shape, hr_shape)


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(dict(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("slicing", [True, False])
def test_horizontal_models_match_jax_both_ways(jax_h, jax_h_flat, slicing):
    """JAX's horizontal G (unsplit hr_conv0/hconv, a bias-free 6-D
    hr_conv1) and instance-norm D (no BatchNorm_0 outside the slicing
    head, whose convs keep batch norm) through params_from_jax and
    d_params_from_jax: the port's keys, forwards within 1e-5 (D in eval
    and train mode), and the trees back bit for bit."""
    jgan, jstate = jax_h if slicing else jax_h_flat
    gan, state = _port(jstate, slicing=slicing)
    lr, hr, z = _batch(3, slicing)
    if slicing:
        params = _np_tree(jstate.params_G)
        assert set(params["hr_conv1"]) == {"kernel"}
        assert params["hr_conv0"]["hconv"]["kernel"].ndim == 6
        assert gan.G.hr_conv1.bias is None
        assert not hasattr(gan.G, "hr_conv0_x")
        assert set(state.params_G) == set(gan.G.state_dict())
        want = np.asarray(jgan.generate(jstate.params_G, lr, z))
        got = gan.generate(state, lr, z).numpy()
        assert _rel_l2(got, want) <= 1e-5
        _same_tree(params_to_jax(state.params_G), params)
        for trunk, head in (("kernel", "modules"), ("modules", "kernel")):
            with pytest.raises(ValueError, match="horizontal_3D"):
                gan.G(torch.from_numpy(lr), torch.from_numpy(z),
                      trunk=trunk, head=head)
    stats = _np_tree(jstate.batch_stats_D)
    assert len(state.batch_stats_D) == (4 if slicing else 0)
    assert set({**state.params_D, **state.batch_stats_D}) == set(
        gan.D.state_dict())
    x = hr[..., :3]
    for train in (False, True):
        want = np.asarray(jax.jit(
            lambda v, x: jgan.D.apply(v, x, train=train,
                                      mutable=["batch_stats"])[0])(
            {"params": jstate.params_D, "batch_stats": jstate.batch_stats_D},
            x))
        got = gan._d_apply(state.params_D, state.batch_stats_D,
                           torch.from_numpy(x), train=train).detach()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    p_back, s_back = d_params_to_jax({**state.params_D,
                                      **state.batch_stats_D})
    _same_tree(p_back, _np_tree(jstate.params_D))
    _same_tree(s_back, stats)


# ------------------------------------------------------------- the steps
def _assert_close_rel(got, want, rtol, atol_frac):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(1e-8, w.abs().max().item())
        torch.testing.assert_close(got[k].detach(), w, rtol=rtol,
                                   atol=atol_frac * scale, msg=k)


def test_horizontal_g_step_grads_match_jax(jax_h):
    """One G step's losses and G gradients (rtol 1e-4, 1e-5 of the largest
    entry), JAX's horizontal G on its XLA path, the port's on its modules,
    both with the stencil kernels."""
    jgan, jstate = jax_h
    gan, state = _port(jstate)
    assert not gan.use_fused_trunk and gan._trunk == "modules"
    batch = make_batch(1)
    keys = jgan._split_keys(jstate.rng)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jgan._g_losses(p, jstate, *batch, jnp.int32(1), keys,
                                 True), has_aux=True))
    (_, (want_losses, _)), want = fn(jstate.params_G)
    _, losses, grads = gan.g_grads(
        state, *(torch.from_numpy(a) for a in batch), 1, state.rng)
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    _assert_close_rel(dict(zip(state.params_G, grads)),
                      params_from_jax(_np_tree(want)), 1e-4, 1e-5)


@pytest.mark.parametrize("slicing", [True, False])
def test_horizontal_instance_d_step_matches_jax(jax_h, jax_h_flat, slicing):
    """One D step of an instance-norm D: its loss, its gradients and its
    statistics, the slicing head's batch norms or none at all; then a
    train_step and val_step of the port on that D (no buffers without
    slicing). With slicing the gradients are held within 5e-5 of each
    tensor's largest entry, as tests/test_torch_train_step.py holds D's.
    Without it, to 1e-4: the last blocks' instance norms normalise over
    2–8 voxels, where the one-pass variance E[x²] − E[x]² cancels most of
    float32's digits, so the two packages' differently ordered sums part
    by up to 8.1e-5 of the largest entry (measured)."""
    jgan, jstate = jax_h if slicing else jax_h_flat
    gan, state = _port(jstate, slicing=slicing)
    assert (len(state.batch_stats_D) == 0) == (not slicing)
    lr, hr, z = _batch(2, slicing)
    keys = jgan._split_keys(jstate.rng)

    def loss_j(p):
        fake = jgan._g_forward_nograd(jstate.params_G, lr, z)
        return jgan._d_loss(p, jstate.batch_stats_D, hr[..., :3], fake,
                            jnp.int32(0), keys, True)

    (want_loss, (want_bs, _, _)), want_g = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(jstate.params_D)
    params = {k: v.detach().requires_grad_() for k, v in
              state.params_D.items()}
    fake = gan._g_forward_nograd(state.params_G, torch.from_numpy(lr),
                                 torch.from_numpy(z))
    loss, _, _ = gan._d_loss(params, state.batch_stats_D,
                             torch.from_numpy(hr)[..., :3], fake, 0,
                             state.rng, True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_g = dict(zip(params, gan._grads(loss, params)))
    want_g = d_params_from_jax(_np_tree(want_g))
    # zero up to rounding: the relativistic-average loss is invariant to a
    # shift of all logits (tests/test_torch_train_step.py)
    assert (got_g.pop("fc1.bias") - want_g.pop("fc1.bias")).abs().max() \
        <= 1e-6
    _assert_close_rel(got_g, want_g, 1e-4, 5e-5 if slicing else 1e-4)
    _assert_close_rel(state.batch_stats_D,
                      d_params_from_jax({}, _np_tree(want_bs)), 1e-5, 1e-5)
    # it 1 is a G step, it 2 a D step
    for g_step in (True, False):
        state, m = gan.train_step(state, lr, hr, z)
        assert int(m["is_g_step"]) == g_step
        assert np.isfinite(float(m["total" if g_step else "D_train_loss"]))
    metrics, stats = gan.val_step(state, lr, hr, z)
    assert np.isfinite(float(metrics["val_PSNR"]))
    assert stats is state.batch_stats_D


# ------------------------------------------------------- the entry points
@pytest.fixture(scope="module")
def trained(jax_h, tmp_path_factory):
    """A port state from JAX's initial state after a G and a D step (EMA
    on), and its pack in float32."""
    _, jstate = jax_h
    gan, state = _port(jstate, g_ema_decay=0.999)
    for seed in (5, 6):
        state, _ = gan.train_step(state, *make_batch(seed))
    path = str(tmp_path_factory.mktemp("hpack") / "h.npz")
    pack_from_state(path, state, store_dtype="float32")
    return gan, state, path


def test_horizontal_pack_both_ways(jax_h, trained, tmp_path):
    """The port's pack reads in JAX (its trees' structure and values), and
    JAX's pack of the same trees loads into a port state bit for bit."""
    jgan, jstate = jax_h
    gan, state, path = trained
    pack = jax_load_continuation(path)
    assert jax.tree.structure(pack["params_G"]) == jax.tree.structure(
        _np_tree(jstate.params_G))
    for k, v in params_from_jax(pack["params_G"]).items():
        assert torch.equal(v, state.params_G[k]), k
    jpath = str(tmp_path / "jax.npz")
    jax_save_continuation(jpath, pack["params_G"], pack["params_D"],
                          pack["batch_stats_D"],
                          params_G_ema=pack["params_G_ema"], it=2,
                          store_dtype="float32")
    fresh = gan.init_state(9, LR_SHAPE, HR_SHAPE)
    loaded = ckpt.load_pack(fresh, jpath)
    assert loaded.it == 2
    for tree in TREES:
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(loaded, tree)[k], v), (tree, k)
    assert load_continuation(jpath)["params_G"]["hr_conv1"].keys() == {
        "kernel"}


def test_horizontal_checkpoint_round_trip_and_mode_check(trained, tmp_path):
    """Save and restore a horizontal state bit for bit (6-D Adam moments
    included); restoring it into a 3D state raises and names the mode."""
    gan, state, _ = trained
    path = ckpt.save_checkpoint(str(tmp_path), state)
    back = ckpt.restore_checkpoint(path, gan.init_state(1, LR_SHAPE,
                                                        HR_SHAPE))
    for tree in TREES:
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(back, tree)[k], v), (tree, k)
    for k, v in state.opt_state_G.nu.items():
        assert torch.equal(back.opt_state_G.nu[k], v), k
    gan3d = WindFieldGAN(tiny_cfg(True), COORDS, COORDS, device="cpu")
    with pytest.raises(ValueError, match="a horizontal_3D checkpoint into "
                                         "a 3D configuration"):
        ckpt.restore_checkpoint(path, gan3d.init_state(0, LR_SHAPE,
                                                       HR_SHAPE))


def test_horizontal_serving_export_and_blend(trained, tmp_path):
    """WindFieldSR serves on the module path (no trunk pack, no head
    weights) and equals gan.generate; upscale_tiled equals its host loop;
    int8 raises as JAX's _generate_q does; the artifact (out_channels from
    the 6-D hr_conv1) equals the served output; the blend of two
    horizontal generators serves; the server's /v1/health answers."""
    gan, state, path = trained
    cfg = h_cfg(True)
    sr = WindFieldSR.from_continuation(cfg, path, use_ema=False,
                                       device="cpu")
    assert sr.packed is None and sr.head_packed is None
    lr, _, z = make_batch(7)
    want = gan.generate(state, lr, z).numpy()
    np.testing.assert_array_equal(sr.upscale(lr, z), want)
    for quantize in (sr.quantize, sr.quantize_trunk):
        with pytest.raises(ValueError, match="fused-trunk"):
            quantize(lr)
    rng = np.random.default_rng(8)
    lr_f = rng.standard_normal((6, 6, 4, 4)).astype(np.float32)
    z_f = rng.standard_normal((24, 24, 4, 1)).astype(np.float32)
    tile, win, coords = _tiling(6, 6, 4, 1, 2, 4)
    np.testing.assert_allclose(
        sr.upscale_tiled(lr_f, z_f, tile=4, overlap=1, batch=2),
        sr._upscale_tiled_host(lr_f, z_f, coords, tile, 2, win),
        rtol=1e-6, atol=1e-6)
    art = str(tmp_path / "h.wsrx")
    header = export_generator(cfg, sr.G.state_dict(), art)
    assert header["out_channels"] == 3
    np.testing.assert_allclose(load_exported(art, device="cpu").upscale(
        lr, z), want, rtol=1e-6, atol=1e-6)
    ema = WindFieldSR.from_continuation(cfg, path, device="cpu")
    blend = blend_params(sr.G.state_dict(), ema.G.state_dict(), 0.5)
    assert blend["hr_conv0.weight"].dim() == 6
    mixed = WindFieldSR(cfg, blend, device="cpu").upscale(lr, z)
    assert mixed.shape == want.shape and np.all(np.isfinite(mixed))
    srv = server.WindFieldServer(("127.0.0.1", 0), sr, tile=4,
                                 tile_overlap=1)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/health"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
        buf = io.BytesIO()
        np.savez(buf, lr=lr[0], z=z[0])
        req = urllib.request.Request(url.replace("health", "upscale"),
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = np.load(io.BytesIO(resp.read()))["sr"]
    finally:
        srv.close()
    assert health["backend"] == "WindFieldSR" and health["scale"] == 4
    np.testing.assert_array_equal(served, sr.upscale(lr[0], z[0]))


def _copy(state):
    """A copy of a state: its trees, Adam states and generator its own."""
    def tree(t):
        return {k: v.clone() for k, v in t.items()}

    rng = torch.Generator()
    rng.set_state(state.rng.get_state())
    adam = [type(o)(o.count.clone(), tree(o.mu), tree(o.nu))
            for o in (state.opt_state_G, state.opt_state_D)]
    return dataclasses.replace(
        state, rng=rng, opt_state_G=adam[0], opt_state_D=adam[1],
        **{t: tree(getattr(state, t)) for t in TREES})


def test_horizontal_train_chunk_is_eager_steps(trained):
    """train_chunk on the CPU (its eager path) of a horizontal GAN equals
    train_step on the batches batch_at cuts from seeded resident volumes:
    steps 3 (D) and 4 (G) from copies of one state."""
    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at

    gan, state, _ = trained
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.standard_normal(
        (3, 32, 32, 4, 4)).astype(np.float32) * 0.3)
    zraw = torch.from_numpy(np.cumsum(1.0 + rng.random(
        (3, 32, 32, 4, 1)), axis=3).astype(np.float32) * 10)
    kw = dict(batch_size=2, patch=16, patch_y=16, cf=4, enable_slicing=True)
    a, b = _copy(state), _copy(state)
    a, _ = gan.train_chunk(a, full, zraw, 11, n_steps=2, **kw)
    for _ in range(2):
        b, _ = gan.train_step(b, *batch_at(full, zraw, 11, b.it, **kw))
    assert a.it == b.it == state.it + 2
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    for tree in TREES:
        for k, v in getattr(a, tree).items():
            assert torch.equal(v, getattr(b, tree)[k]), (tree, k)


def test_instance_norm_d_pth_and_horizontal_g_pth(tmp_path):
    """A reference D_{it}.pth with instance norm has no norm entries but
    the slicing head's: the port reads it as JAX's import does, exactly. A
    horizontal G or D has no reference layout and raises, naming it."""
    d3 = Discriminator3D(base_features=4, enable_slicing=True,
                         number_of_z_layers=4, norm="instance",
                         spatial=(16, 16),
                         generator=torch.Generator().manual_seed(4))
    sd = torch_import.export_discriminator_state_dict(
        dict(d3.named_parameters()), dict(d3.named_buffers()), d3)
    assert not [k for k in sd if k.startswith("features.1.0.1.")]
    path = str(tmp_path / "D_1.pth")
    torch.save(sd, path)
    params, stats = torch_import.load_reference_discriminator(d3, path)
    assert list(stats) == [k for k, _ in d3.named_buffers()]
    jp, js = jax_import_d({k: v.numpy() for k, v in sd.items()},
                          JaxD(base_features=4, enable_slicing=True,
                               number_of_z_layers=4, norm="instance"))
    want = d_params_from_jax(jp, js)
    assert set(want) == {*params, *stats}
    for k, v in {**params, **stats}.items():
        assert torch.equal(v, want[k]), k
    gan = WindFieldGAN(h_cfg(True), COORDS, COORDS, device="cpu")
    gan.init_state(0, LR_SHAPE, HR_SHAPE)
    with pytest.raises(ValueError, match="horizontal_3D"):
        torch_import.import_generator_state_dict({}, gan.G)
    with pytest.raises(ValueError, match="horizontal_3D"):
        torch_import.load_reference_discriminator(gan.D, path)


def test_cli_on_a_horizontal_pack(trained, tmp_path, monkeypatch):
    """--test, --use and --serve read a horizontal pack: --test's
    averages are finite, --use's G is the pack's, --serve's backend runs
    the module path."""
    from gan_sr_wind_field_tpu_torch import run

    monkeypatch.chdir(tmp_path)
    _, state, path = trained
    cfg = h_cfg(True)
    cfg.use_tensorboard_logger = cfg.also_log_to_terminal = False
    cfg.env.data_root = str(tmp_path / "data")
    cfg.env.root_path = str(tmp_path)
    cfg.env.this_runs_folder = str(tmp_path / "run")
    cfg.env.generator_load_path = path
    ini = str(tmp_path / "tiny_h.ini")
    cfg.save(ini)

    def cli(*flags):
        return run.main(["--cfg", ini, "--synthetic", "--synthetic_hours",
                         "30", "--synthetic_size", "32", "--device", "cpu",
                         *flags])

    assert np.isfinite(cli("--test")["PSNR"])
    used = cli("--use", "--no_ema")
    for k, v in state.params_G.items():
        assert torch.equal(used.params_G[k], v), k
    captured = {}
    monkeypatch.setattr(server, "serve",
                        lambda backend, **kw: captured.update(b=backend))
    cli("--serve", "0")
    assert captured["b"].packed is None
