"""PyTorch port on a mesh with a model axis against the JAX package's
``make_mesh(2, 2)`` (tests/test_parallel.py:test_dp_tp_step_runs): four
gloo ranks on the CPU (``tests/_torch_dp_worker.py``, one spawn for the
module), data 2 × model 2, from the same JAX state
(``utils/jax_params.py``) and numpy batches of 4 at the tiny geometry
(``tests/_torch_tiny.py``: nf 8, gc 4 and 4 terrain features divide over
the model axis; hr_conv1's 3 outputs stay whole), with gradient clipping
acting (max_norm far under the gradients' norm) and weight decay on G, so
that the clipped gradients, not only their direction, reach the update.

Checked: G's forward (JAX's spatial bound, rtol 2e-4 / atol 1e-5), one G
step's losses and gathered gradients and the global norm the step clips
by, one D step's, ``val_step``, a 3-step trajectory with ``augment=True``
across the G→D boundary (JAX's draws fed to the port's augmentation; the
losses, G_grad_norm, G, its EMA and D's statistics within 1e-3, D's
entries to 2·lr per D step), ``WindFieldSR(mesh=)`` against JAX's serving
on the same mesh, and three negative controls that must miss JAX: the
gathered cotangent summed over the model group with no identity before the
conv, the clipping norm over each rank's own slices only, and G's sharded
gradients summed over a group that spans the model axis. The step
tolerances are the data mesh's (tests/test_torch_parallel_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxSR
from gan_sr_wind_field_tpu.parallel import (
    batch_sharding,
    make_mesh,
    shard_state,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)
from test_torch_parallel_step import (
    D_TOL,
    G_TOL,
    STATS_TOL,
    TRAJ_TOL,
    _assert_params,
    _err,
    _port_state,
)

N = 4
AXES = (2, 2)
CONTROLS = ("no_pair", "local_norm", "grads_over_model")
# far under the tiny G's gradient norms (8.3e-3 and 4.8e-3): clipping acts
MAX_NORM = 2e-4
WD_G = 1e-4


def model_cfg(port: bool, **training):
    """The tiny configuration with clipping at MAX_NORM and G's weight
    decay."""
    cfg = tiny_cfg(port, use_grad_clipping=True, adam_weight_decay_g=WD_G,
                   **training)
    cfg.generator.max_norm = MAX_NORM
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _global_norm(grads: dict) -> float:
    return float(np.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values())))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's results on make_mesh(2, 2), the port's on 4 gloo ranks)."""
    jmesh = make_mesh(*AXES)
    ds = batch_sharding(jmesh)
    jgan = JaxGAN(model_cfg(False), COORDS, COORDS, mesh=jmesh)
    jstate0 = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    batches = dict(g_batch=make_batch(1, n=N), d_batch=make_batch(2, n=N),
                   val_batch=make_batch(4, n=N),
                   gen_batch=make_batch(5, n=N),
                   traj=[make_batch(10 + i, n=N) for i in range(3)])

    def put(batch):
        return tuple(jax.device_put(a, ds) for a in batch)

    jst = shard_state(jax.tree.map(jnp.copy, jstate0), jmesh)
    want = {}
    lr, _, z = put(batches["gen_batch"])
    want["generate"] = np.asarray(jgan.generate(jst.params_G, lr, z))
    keys = jgan._split_keys(jst.rng)
    (_, (losses, _)), grads = jax.jit(jax.value_and_grad(
        lambda p: jgan._g_losses(p, jst, *put(batches["g_batch"]),
                                 jnp.int32(1), keys, True),
        has_aux=True))(jst.params_G)
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
    # the trajectory with augmentation; its draws are handed to the port
    jgan3 = JaxGAN(model_cfg(False, g_ema_decay=0.999), COORDS, COORDS,
                   mesh=jmesh)
    j = jax.tree.map(jnp.copy, jstate0)
    j = shard_state(j.replace(params_G_ema=jax.tree.map(jnp.copy,
                                                        j.params_G)), jmesh)
    steps, aug = [], []
    for batch in batches["traj"]:
        k_rot, k_fx, k_fy = jax.random.split(jgan3._split_keys(j.rng)["aug"],
                                             3)
        aug.append((np.asarray(jax.random.randint(k_rot, (N,), 0, 4)),
                    np.asarray(jax.random.bernoulli(k_fx, 0.5, (N,))),
                    np.asarray(jax.random.bernoulli(k_fy, 0.5, (N,)))))
        j, mj = jgan3.train_step(j, *put(batch), augment=True)
        steps.append({k: float(v) for k, v in mj.items()})
    want["traj"] = (steps, params_from_jax(_np(j.params_G)),
                    params_from_jax(_np(j.params_G_ema)),
                    d_params_from_jax(_np(j.params_D), _np(j.batch_stats_D)))
    serve_lr, _, serve_z = make_batch(6, n=N)
    want["serve"] = JaxSR(jgan, jstate0.params_G, mesh=jmesh).upscale(
        serve_lr, serve_z)
    got = spawn("jax_step", AXES[0] * AXES[1],
                tmp_path_factory.mktemp("tp4"),
                dict(cfg=model_cfg(True), coords=COORDS, axes=AXES,
                     controls=CONTROLS, state=_port_state(jstate0), aug=aug,
                     serve=(params_from_jax(_np(jstate0.params_G)),
                            serve_lr, serve_z), **batches))
    return want, got


def test_generator_forward_on_model_mesh_matches_jax(both):
    """G with its convs' output channels over two model ranks, gathered
    over the rows, against JAX's forward on make_mesh(2, 2)."""
    want, got = both
    assert got["generate"].shape == (N, 16, 16, 4, 3)
    np.testing.assert_allclose(got["generate"].numpy(), want["generate"],
                               rtol=2e-4, atol=1e-5)


def test_g_step_on_model_mesh_matches_jax(both):
    """Every loss, every G gradient gathered whole over the model axis and
    summed over the data axis, and the global norm the step clips by (its
    sharded leaves' squares summed over the model group) against
    optax.global_norm of JAX's gradients; that norm is over 10x max_norm,
    so the clipping acts."""
    want, got = both
    (wl, wg), (gl, gg) = want["g"], got["g"]
    for k, v in wl.items():
        np.testing.assert_allclose(gl[k], v, rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    _assert_params(gg, wg, G_TOL)
    norm = _global_norm(wg)
    assert norm > 10 * MAX_NORM
    np.testing.assert_allclose(got["g_norm"], norm, rtol=1e-5)


def test_d_step_on_model_mesh_matches_jax(both):
    """The D loss, D's gradients (replicated over the model axis, averaged
    over it) and the batch statistics moved over the rows."""
    want, got = both
    (wl, wg, ws), (gl, gg, gs) = want["d"], got["d"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    _assert_params(gg, wg, D_TOL)
    _assert_params(gs, ws, STATS_TOL)


def test_val_step_on_model_mesh_matches_jax(both):
    want, got = both
    (wm, ws), (gm, gs) = want["val"], got["val"]
    assert set(gm) == set(wm)
    for k, v in wm.items():
        np.testing.assert_allclose(gm[k], v, rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    _assert_params(gs, ws, STATS_TOL)


def test_three_augmented_steps_on_model_mesh_match_jax(both):
    """G, D, D with augmentation (JAX's draws), clipping and the EMA on,
    as JAX's test_dp_tp_step_runs: each step's losses and G_grad_norm
    within 1e-3, G (gathered) and its EMA and D's statistics within 1e-3
    of each tensor's largest entry, D's entries within 2·lr per D step
    (tests/test_torch_parallel_step.py says why), and every rank's whole
    state equal bit for bit: the replicated leaves on every rank, G on
    every model group."""
    want, got = both
    (ws, wg, we, wd), (gs, gg, ge, gd) = want["traj"], got["traj"]
    assert [m["is_g_step"] for m in ws] == [1.0, 0.0, 0.0]
    assert ws[0]["G_grad_norm"] > 10 * MAX_NORM
    for mj, mp in zip(ws, gs):
        assert mp["is_g_step"] == mj["is_g_step"]
        for k in ("total", "pix", "xy_gradient", "divergence",
                  "adversarial", "D_train_loss", "G_grad_norm"):
            np.testing.assert_allclose(mp[k], mj[k], rtol=1e-3, atol=1e-9,
                                       err_msg=k)
    _assert_params(gg, wg, TRAJ_TOL)
    _assert_params(ge, we, TRAJ_TOL)
    stats = {k: v for k, v in wd.items() if k.endswith((".mean", ".var"))}
    _assert_params({k: gd[k] for k in stats}, stats, TRAJ_TOL)
    for k, w in wd.items():
        if k not in stats:
            assert (gd[k] - w).abs().max() <= 2 * 1e-3 * 2, k
    assert got["same_on_every_rank"]


@pytest.mark.parametrize("where", CONTROLS)
def test_each_wrong_model_place_misses_jax(both, where):
    """The negative controls: with the gathered cotangent summed over the
    model group and no identity before the conv (the replicated path
    counted twice), or G's sharded gradients summed over a group that
    spans the model axis (two ranks' different channels added), G's
    gradients miss JAX's by more than 10x the tolerance; with the clipping
    norm over each rank's own slices, the norm misses optax.global_norm by
    more than 10x its tolerance. The right step is inside both bounds by
    the same measures."""
    want, got = both
    if where == "local_norm":
        norm = _global_norm(want["g"][1])
        assert abs(got["local_local_norm"] - norm) > 10 * 1e-5 * norm
    else:
        err = _err(got[f"local_{where}"], want["g"][1])
        assert err > 10 * G_TOL[1], (where, err)
    assert _err(got["g"][1], want["g"][1]) <= G_TOL[0] + G_TOL[1]
    assert abs(got["g_norm"] - _global_norm(want["g"][1])) <= \
        1e-5 * _global_norm(want["g"][1])


def test_serving_on_model_mesh_matches_jax(both):
    """``WindFieldSR(mesh=)`` on data 2 × model 2: the whole batch on
    every rank, within JAX's bound of JAX's serving on make_mesh(2, 2)."""
    want, got = both
    assert got["serve"].shape == (N, 16, 16, 4, 3) and got["serve_same"]
    np.testing.assert_allclose(got["serve"], want["serve"], rtol=2e-4,
                               atol=1e-5)
