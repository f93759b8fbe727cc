"""PyTorch port on a data mesh: one G step, one D step, val_step and an
8-step trajectory on 2 and 4 gloo ranks (CPU processes,
``tests/_torch_dp_worker.py``) against the JAX package's WindFieldGAN on
``make_mesh(2|4, 1)`` over its virtual CPU devices, from the same JAX
state (through ``utils/jax_params.py``) and numpy batches of 4; the port
on the mesh against itself in one process with every random draw on; and
the negative controls.

The tolerances are the single-process tests' (tests/test_torch_train_step
.py): G gradients rtol 1e-4 / atol 1e-5 of the largest entry, D gradients
5e-5 and statistics 1e-5 of the largest, 1e-3 over 8 steps. Instance noise,
noisy labels and dropout are off against JAX (the two packages draw
different numbers), on against the port in one process (the mesh draws at
the global batch's shape, so the draws are the same), which the mesh must
match within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.parallel import (
    batch_sharding,
    make_mesh,
    shard_state,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)

N = 4  # the global batch: divides over 2 and 4 ranks
G_TOL = (1e-4, 1e-5)
D_TOL = (1e-4, 5e-5)
STATS_TOL = (1e-5, 1e-5)
TRAJ_TOL = (1e-3, 1e-3)
# the last layer's bias gradient in a D step is the batch's sum of dL/dlogit,
# which the relativistic-average loss makes zero up to rounding (it is
# invariant to a shift of all logits): held to an absolute bound
ZERO_SUM = "fc1.bias"
ZERO_SUM_ATOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got: dict, want: dict) -> float:
    """The largest difference of any tensor over its largest entry (D's
    ZERO_SUM left out)."""
    return max(float((got[k].detach() - w).abs().max())
               / max(float(w.abs().max()), 1e-8) for k, w in want.items()
               if k != ZERO_SUM)


def _assert_params(got, want, tol):
    rtol, atol_frac = tol
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(1e-8, w.abs().max().item())
        if k == ZERO_SUM and tol == D_TOL:
            assert (got[k] - w).abs().max() <= ZERO_SUM_ATOL, k
            continue
        torch.testing.assert_close(got[k].detach(), w, rtol=rtol,
                                   atol=atol_frac * scale, msg=k)


def _port_state(jstate):
    gan = WindFieldGAN(tiny_cfg(True), COORDS, COORDS, device="cpu")
    state = gan.state_from_jax(jstate, HR_SHAPE)
    return dict(params_G=state.params_G, params_D=state.params_D,
                batch_stats_D=state.batch_stats_D, it=state.it,
                lr_shape=LR_SHAPE, hr_shape=HR_SHAPE)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def both(request, tmp_path_factory):
    """(JAX's results on make_mesh(W, 1), the port's on W gloo ranks)."""
    world = request.param
    jmesh = make_mesh(world, 1)
    ds = batch_sharding(jmesh)
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS, mesh=jmesh)
    jstate0 = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    batches = dict(g_batch=make_batch(1, n=N), d_batch=make_batch(2, n=N),
                   val_batch=make_batch(4, n=N),
                   traj=[make_batch(10 + i, n=N) for i in range(8)])

    def put(batch):
        return tuple(jax.device_put(a, ds) for a in batch)

    jst = shard_state(jax.tree.map(jnp.copy, jstate0), jmesh)
    want = {}
    keys = jgan._split_keys(jst.rng)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jgan._g_losses(p, jst, *put(batches["g_batch"]),
                                 jnp.int32(1), keys, True), has_aux=True))
    (_, (losses, _)), grads = fn(jst.params_G)
    want["g"] = ({k: float(v) for k, v in losses.items()},
                 params_from_jax(_np(grads)))

    lr, hr, z = put(batches["d_batch"])

    def loss_d(p):
        fake = jgan._g_forward_nograd(jst.params_G, lr, z)
        return jgan._d_loss(p, jst.batch_stats_D, hr[..., :3], fake,
                            jnp.int32(0), keys, True)

    (loss, (bs, _, _)), g = jax.jit(jax.value_and_grad(
        loss_d, has_aux=True))(jst.params_D)
    want["d"] = (float(loss), d_params_from_jax(_np(g)),
                 d_params_from_jax({}, _np(bs)))
    m, bs = jgan.val_step(jst, *put(batches["val_batch"]))
    want["val"] = ({k: float(v) for k, v in m.items()},
                   d_params_from_jax({}, _np(bs)))
    jgan8 = JaxGAN(tiny_cfg(False, g_ema_decay=0.999), COORDS, COORDS,
                   mesh=jmesh)
    j8 = jax.tree.map(jnp.copy, jstate0)
    j8 = shard_state(j8.replace(params_G_ema=jax.tree.map(
        jnp.copy, j8.params_G)), jmesh)
    steps = []
    for batch in batches["traj"]:
        j8, mj = jgan8.train_step(j8, *put(batch))
        steps.append({k: float(v) for k, v in mj.items()})
    want["traj"] = (steps, params_from_jax(_np(j8.params_G)),
                    params_from_jax(_np(j8.params_G_ema)),
                    d_params_from_jax(_np(j8.params_D),
                                      _np(j8.batch_stats_D)))
    got = spawn("jax_step", world,
                tmp_path_factory.mktemp(f"dp{world}"),
                dict(cfg=tiny_cfg(True), coords=COORDS,
                     state=_port_state(jstate0), **batches))
    return want, got


def test_g_step_on_mesh_matches_jax(both):
    """Every loss (the batch's, on every rank) and every G gradient summed
    over the ranks."""
    want, got = both
    (wl, wg), (gl, gg) = want["g"], got["g"]
    for k, v in wl.items():
        np.testing.assert_allclose(gl[k], v, rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    _assert_params(gg, wg, G_TOL)


def test_d_step_on_mesh_matches_jax(both):
    """The D loss (with the -0.1985 bias), its gradients (ZERO_SUM to an
    absolute 1e-6) and the batch statistics moved by two train-mode
    forwards over the group's rows."""
    want, got = both
    (wl, wg, ws), (gl, gg, gs) = want["d"], got["d"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    _assert_params(gg, wg, D_TOL)
    _assert_params(gs, ws, STATS_TOL)


def test_val_step_on_mesh_matches_jax(both):
    want, got = both
    (wm, ws), (gm, gs) = want["val"], got["val"]
    assert set(gm) == set(wm)
    for k, v in wm.items():
        np.testing.assert_allclose(gm[k], v, rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    _assert_params(gs, ws, STATS_TOL)


def test_eight_steps_on_mesh_match_jax(both):
    """Per-step losses to 1e-4, the final G, EMA and D's statistics to
    1e-3 of each tensor's largest entry, and every rank's state equal bit
    for bit, the generator's included. D's parameters are held entry by
    entry to 2·lr per D step and, but for the biases, each tensor to 5e-3
    relative L2 (1.6e-3 measured): Adam divides by sqrt(nu) ~ |g| on its first steps, so an
    entry whose gradient is near zero takes a step of up to ±lr either way
    on a rounding difference (the single-process test holds D's two last
    biases so). At this batch of 4 that moves up to ~1 % of a D conv's
    entries past the single-process bound, between JAX on 4 devices and
    JAX on one as much as between the packages. The biases start at zero, so no tensor scale holds them,
    and their gradients are near zero sums (the relativistic-average loss
    is invariant to a shift of all logits, a batch norm to a shift of its
    input)."""
    want, got = both
    (ws, wg, we, wd), (gs, gg, ge, gd) = want["traj"], got["traj"]
    for mj, mp in zip(ws, gs):
        assert mp["is_g_step"] == mj["is_g_step"]
        for k in ("total", "pix", "xy_gradient", "divergence",
                  "adversarial", "D_train_loss"):
            np.testing.assert_allclose(mp[k], mj[k], rtol=1e-4, atol=1e-9,
                                       err_msg=k)
    _assert_params(gg, wg, TRAJ_TOL)
    _assert_params(ge, we, TRAJ_TOL)
    d_steps = sum(1 - m["is_g_step"] for m in ws)
    stats = {k: v for k, v in wd.items() if k.endswith((".mean", ".var"))}
    _assert_params({k: gd[k] for k in stats}, stats, TRAJ_TOL)
    for k, w in wd.items():
        if k in stats:
            continue
        diff = gd[k] - w
        assert diff.abs().max() <= 2 * 1e-3 * d_steps, k
        if not k.endswith(".bias"):
            assert diff.norm() <= 5e-3 * w.norm(), k
    assert got["same_on_every_rank"]


@pytest.mark.parametrize("where", ["ragan", "physics", "bn"])
def test_each_rank_alone_misses_jax(both, where):
    """The negative control: with one of the three batch-global places
    taken over each rank's rows alone (its gradients then averaged, as a
    naive data-parallel step does), the step misses JAX's by more than 10x
    the tolerance, so the test batch tells the global from the local.
    The RaGAN means and batch statistics show in D's gradients, the
    physics maxima in G's."""
    want, got = both
    if where == "physics":
        err, tol = _err(got["local_physics"], want["g"][1]), G_TOL[1]
    else:
        err, tol = _err(got[f"local_{where}"][1], want["d"][1]), D_TOL[1]
    assert err > 10 * tol, (where, err)
    # and the global step is inside the tolerance by the same measure
    assert _err(got["g"][1], want["g"][1]) <= G_TOL[0] + G_TOL[1]
    assert _err(got["d"][1], want["d"][1]) <= D_TOL[0] + D_TOL[1]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_equals_one_process_with_every_draw(tmp_path, world):
    """Instance noise, noisy labels, G and D dropout and augmentation on,
    the mesh against one process on the global batches from one state and
    one generator state: a validation batch, one G step's losses and
    gradients and one D step's loss, gradients and moved statistics within
    1e-5 relative (each tensor's L2; D's ZERO_SUM to 1e-6 absolute); then
    four steps (D, D, G, G), whose G and EMA stay within 1e-5 and D
    within 1e-5 but for its biases (2·lr per D step, as the 8-step test
    says why); the generator ends in the same state, and every rank's
    state is the same bit for bit."""
    cfg = tiny_cfg(True, dropout=0.1, use_instance_noise=True,
                   use_noisy_labels=True, g_ema_decay=0.999)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    st = gan.init_state(3, LR_SHAPE, HR_SHAPE)
    state = dict(params_G=st.params_G, params_D=st.params_D,
                 batch_stats_D=st.batch_stats_D, it=1,
                 lr_shape=LR_SHAPE, hr_shape=HR_SHAPE)
    got = spawn("port_vs_port", world, tmp_path,
                dict(cfg=cfg, coords=COORDS, state=state,
                     traj=[make_batch(20 + i, n=N) for i in range(4)]))
    assert got["same_on_every_rank"] and got["same_rng"]
    errs = dict(got["errs"])
    assert errs.pop("D grad fc1.bias abs") <= ZERO_SUM_ATOL
    bad = {k: v for k, v in errs.items() if not v <= 1e-5}
    assert not bad, bad
    assert got["bias_diff"] <= 2 * 1e-3 * 2  # two D steps
