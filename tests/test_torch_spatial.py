"""PyTorch port on a mesh with a spatial axis against the JAX package's
``make_mesh(2, 1, 4)`` (tests/test_spatial.py): eight gloo ranks on the
CPU (``tests/_torch_dp_worker.py``, the suite's one eight-rank world),
data 2 × spatial 4, from the same JAX state (``utils/jax_params.py``) and
numpy batches of 4 at the tiny geometry (``tests/_torch_tiny.py``: LR x
extent 4, so each rank's LR slab is one plane and D gathers its features
at its third block). The same eight ranks then build a second mesh, data
4 × spatial 2, against JAX's ``make_mesh(4, 1, 2)``: there each LR slab
holds two planes, each reading its neighbour's, and D runs on slabs to
the flatten (HR slabs of 8 planes halve to one, the head's convs take
their halo on one-plane slabs), as at fullvol. Last, the same ranks build
all three axes at once, data 2 × model 2 × spatial 2, against JAX's
``make_mesh(2, 2, 2)`` (tests/test_spatial.py:test_dp_tp_sp_step_runs; the
geometry of tests/test_flagship_mesh.py): G's forward, a G step and a D
step, each conv's halo taken on the whole-channel slab and its output
channels gathered over the model pair, with the ranks in JAX's device
order.

Checked: G's forward (JAX's own spatial bound, rtol 2e-4 / atol 1e-5),
one G step's losses and gradients, one D step's, ``val_step``, a 3-step
trajectory across the G→D boundary (JAX's own 1e-3, and D against JAX on
one device, the reference JAX's own test holds its mesh to),
``WindFieldSR(mesh=)``
against JAX's spatial serving, and three negative controls that must miss
JAX: slabs zero-padded as if each were its own volume (no halo), D's
per-sample terms counted whole on every rank of a data row, and D's batch
statistics over the ranks of one slab only. The step tolerances are the
data mesh's (tests/test_torch_parallel_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dp_worker import spawn
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxSR
from gan_sr_wind_field_tpu.parallel import (
    make_mesh,
    shard_state,
    volume_sharding,
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
AXES = (2, 1, 4)
AXES2 = (4, 1, 2)
AXES3 = (2, 2, 2)
CONTROLS = ("no_halo", "per_sample_once", "bn_data_group")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mesh_run(jmesh, jstate0, batches, key):
    """JAX's G forward, one G step's losses and gradients and one D
    step's on ``jmesh``, under ``key`` + 'generate', 'g', 'd'."""
    vs = volume_sharding(jmesh)
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS, mesh=jmesh)
    jst = shard_state(jax.tree.map(jnp.copy, jstate0), jmesh)

    def put(batch):
        return tuple(jax.device_put(a, vs) for a in batch)

    want = {}
    lr, _, z = put(batches["gen_batch"])
    want[f"generate{key}"] = np.asarray(jgan.generate(jst.params_G, lr, z))
    keys = jgan._split_keys(jst.rng)
    (_, (losses, _)), grads = jax.jit(jax.value_and_grad(
        lambda p: jgan._g_losses(p, jst, *put(batches["g_batch"]),
                                 jnp.int32(1), keys, True),
        has_aux=True))(jst.params_G)
    want[f"g{key}"] = ({k: float(v) for k, v in losses.items()},
                       params_from_jax(_np(grads)))
    lr, hr, z = put(batches["d_batch"])

    def loss_d(p):
        fake = jgan._g_forward_nograd(jst.params_G, lr, z)
        return jgan._d_loss(p, jst.batch_stats_D, hr[..., :3], fake,
                            jnp.int32(0), keys, True)

    (loss, (bs, _, _)), g = jax.jit(jax.value_and_grad(
        loss_d, has_aux=True))(jst.params_D)
    want[f"d{key}"] = (float(loss), d_params_from_jax(_np(g)),
                       d_params_from_jax({}, _np(bs)))
    if key == "3":  # the device at each (data, model, spatial) place
        want["devices3"] = np.vectorize(lambda d: d.id)(jmesh.devices)
        # G's forward on one device: JAX's own generate on this mesh is
        # not its forward (test_all_three_axes_match_jax)
        lr, _, z = batches["gen_batch"]
        one = JaxGAN(tiny_cfg(False), COORDS, COORDS)
        want["generate_one"] = np.asarray(one.generate(jstate0.params_G, lr,
                                                       z))
    return want


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's results on make_mesh(2, 1, 4), the port's on 8 gloo
    ranks)."""
    jmesh = make_mesh(*AXES)
    vs = volume_sharding(jmesh)
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS, mesh=jmesh)
    jstate0 = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    batches = dict(g_batch=make_batch(1, n=N), d_batch=make_batch(2, n=N),
                   val_batch=make_batch(4, n=N),
                   gen_batch=make_batch(5, n=N),
                   traj=[make_batch(10 + i, n=N) for i in range(3)])

    def put(batch):
        return tuple(jax.device_put(a, vs) for a in batch)

    jst = shard_state(jax.tree.map(jnp.copy, jstate0), jmesh)
    want = {}
    lr, _, z = put(batches["gen_batch"])
    want["generate"] = np.asarray(jgan.generate(jst.params_G, lr, z))
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
    # the trajectory on JAX's mesh, and unsharded (the reference JAX's
    # tests/test_spatial.py holds its mesh to)
    jgan3 = JaxGAN(tiny_cfg(False, g_ema_decay=0.999), COORDS, COORDS,
                   mesh=jmesh)
    jgan1 = JaxGAN(tiny_cfg(False, g_ema_decay=0.999), COORDS, COORDS)
    j0 = jax.tree.map(jnp.copy, jstate0)
    j0 = j0.replace(params_G_ema=jax.tree.map(jnp.copy, j0.params_G))
    for key, g, j in (("traj", jgan3, shard_state(j0, jmesh)),
                      ("traj_one", jgan1, jax.tree.map(jnp.copy, j0))):
        steps = []
        for batch in batches["traj"]:
            j, mj = g.train_step(j, *(put(batch) if g.mesh else batch))
            steps.append({k: float(v) for k, v in mj.items()})
        want[key] = (steps, params_from_jax(_np(j.params_G)),
                     params_from_jax(_np(j.params_G_ema)),
                     d_params_from_jax(_np(j.params_D),
                                       _np(j.batch_stats_D)))
    # the second and third meshes: G's forward, one G step's and one D
    # step's gradients
    for key, axes in (("2", AXES2), ("3", AXES3)):
        want.update(_jax_mesh_run(make_mesh(*axes), jstate0, batches, key))
    serve_lr, _, serve_z = make_batch(6, n=N)
    want["serve"] = JaxSR(jgan, jstate0.params_G, mesh=jmesh).upscale(
        serve_lr, serve_z)
    got = spawn("jax_step", AXES[0] * AXES[2],
                tmp_path_factory.mktemp("sp8"),
                dict(cfg=tiny_cfg(True), coords=COORDS, axes=AXES,
                     axes2=AXES2, axes3=AXES3,
                     controls=CONTROLS, state=_port_state(jstate0),
                     serve=(params_from_jax(_np(jstate0.params_G)),
                            serve_lr, serve_z), **batches))
    return want, got


def test_generator_forward_on_spatial_mesh_matches_jax(both):
    """G on 8 ranks' slabs, gathered, against JAX's forward on its
    spatially sharded inputs: tests/test_spatial.py's own bound."""
    want, got = both
    assert got["generate"].shape == (N, 16, 16, 4, 3)
    np.testing.assert_allclose(got["generate"].numpy(), want["generate"],
                               rtol=2e-4, atol=1e-5)


def test_g_step_on_spatial_mesh_matches_jax(both):
    """Every loss (the batch's, on every rank) and every G gradient summed
    over the eight ranks."""
    want, got = both
    (wl, wg), (gl, gg) = want["g"], got["g"]
    for k, v in wl.items():
        np.testing.assert_allclose(gl[k], v, rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    _assert_params(gg, wg, G_TOL)


def test_d_step_on_spatial_mesh_matches_jax(both):
    """The D loss, its gradients (through the gather at the third block)
    and the batch statistics moved over every rank's rows and slabs."""
    want, got = both
    (wl, wg, ws), (gl, gg, gs) = want["d"], got["d"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    _assert_params(gg, wg, D_TOL)
    _assert_params(gs, ws, STATS_TOL)


def test_val_step_on_spatial_mesh_matches_jax(both):
    """The metrics (the trilinear baseline's on slabs with one neighbour
    plane) and D's moved statistics."""
    want, got = both
    (wm, ws), (gm, gs) = want["val"], got["val"]
    assert set(gm) == set(wm)
    for k, v in wm.items():
        np.testing.assert_allclose(gm[k], v, rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    _assert_params(gs, ws, STATS_TOL)


def test_three_steps_on_spatial_mesh_match_jax(both):
    """G, D, D (d_g_train_period 2), from one state with the EMA on. Against
    JAX on make_mesh(2, 1, 4): every step's losses to 1e-3, JAX's own bound
    for its mesh against one device (tests/test_spatial.py), and G and its
    EMA to 1e-3 of each tensor's largest entry. D is held against JAX on
    one device, the reference that test holds JAX's mesh to: JAX's mesh
    itself lies up to 2·lr per D step from it in D's entries (Adam divides
    by sqrt(nu) ~ |g| on its first steps, so an entry whose gradient is near
    zero steps ±lr on a rounding difference) and then 0.5 relative in the
    running mean that follows, while the port on the mesh stays within
    1e-3 of each tensor's largest entry in G, the EMA, D and D's
    statistics, but for D's biases: they start at zero, so no tensor scale
    holds them, and their gradients are near-zero sums, held to 2·lr per D
    step as the data mesh's test holds them. Every rank's state is equal
    bit for bit."""
    want, got = both
    (ws, wg, we, _), (gs, gg, ge, gd) = want["traj"], got["traj"]
    assert [m["is_g_step"] for m in ws] == [1.0, 0.0, 0.0]
    for mj, mp in zip(ws, gs):
        assert mp["is_g_step"] == mj["is_g_step"]
        for k in ("total", "pix", "xy_gradient", "divergence",
                  "adversarial", "D_train_loss"):
            np.testing.assert_allclose(mp[k], mj[k], rtol=1e-3, atol=1e-9,
                                       err_msg=k)
    _assert_params(gg, wg, TRAJ_TOL)
    _assert_params(ge, we, TRAJ_TOL)
    _, og, oe, od = want["traj_one"]
    _assert_params(gg, og, TRAJ_TOL)
    _assert_params(ge, oe, TRAJ_TOL)
    biases = [k for k in od if k.endswith(".bias")]
    _assert_params({k: v for k, v in gd.items() if k not in biases},
                   {k: v for k, v in od.items() if k not in biases},
                   TRAJ_TOL)
    for k in biases:  # from zero, on near-zero gradients: 2·lr per D step
        assert (gd[k] - od[k]).abs().max() <= 2 * 1e-3 * 2, k
    assert got["same_on_every_rank"]


@pytest.mark.parametrize("where", CONTROLS)
def test_each_wrong_place_misses_jax(both, where):
    """The negative controls: with the halo dropped (each slab
    zero-padded as its own volume; G's gradients), D's per-sample terms
    counted whole on every rank of a data row, or D's batch statistics
    over the ranks of one slab (D's gradients), the step misses JAX's by
    more than 10x the tolerance, and the step with every place right is
    inside it by the same measure."""
    want, got = both
    if where == "no_halo":
        err, tol = _err(got[f"local_{where}"], want["g"][1]), G_TOL[1]
    else:
        err, tol = _err(got[f"local_{where}"][1], want["d"][1]), D_TOL[1]
    assert err > 10 * tol, (where, err)
    assert _err(got["g"][1], want["g"][1]) <= G_TOL[0] + G_TOL[1]
    assert _err(got["d"][1], want["d"][1]) <= D_TOL[0] + D_TOL[1]


def test_serving_on_spatial_mesh_matches_jax(both):
    """``WindFieldSR(mesh=)`` on data 2 × spatial 4: the whole batch on
    every rank, within JAX's bound of JAX's ``WindFieldSR(mesh=)`` on
    make_mesh(2, 1, 4)."""
    want, got = both
    assert got["serve"].shape == (N, 16, 16, 4, 3) and got["serve_same"]
    np.testing.assert_allclose(got["serve"], want["serve"], rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("what", ["generate", "g", "d"])
def test_slabs_to_the_flatten_match_jax(both, what):
    """On data 4 × spatial 2 against JAX's make_mesh(4, 1, 2): G's
    forward on two-plane LR slabs (JAX's spatial bound), one G step's
    losses and gradients, and one D step's loss, gradients and moved
    statistics with D on slabs down to one plane and its gather just
    before the flatten; the tolerances of the first mesh."""
    want, got = both
    if what == "generate":
        assert got["generate2"].shape == (N, 16, 16, 4, 3)
        np.testing.assert_allclose(got["generate2"].numpy(),
                                   want["generate2"], rtol=2e-4, atol=1e-5)
    elif what == "g":
        (wl, wg), (gl, gg) = want["g2"], got["g2"]
        for k, v in wl.items():
            np.testing.assert_allclose(gl[k], v, rtol=1e-5, atol=1e-9,
                                       err_msg=k)
        _assert_params(gg, wg, G_TOL)
    else:
        (wl, wg, ws), (gl, gg, gs) = want["d2"], got["d2"]
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        _assert_params(gg, wg, D_TOL)
        _assert_params(gs, ws, STATS_TOL)


@pytest.mark.parametrize("what", ["generate", "g", "d"])
def test_all_three_axes_match_jax(both, what):
    """On data 2 × model 2 × spatial 2 against JAX's make_mesh(2, 2, 2):
    one G step's losses and gradients gathered whole, and one D step's
    loss, gradients and moved statistics, at the spatial mesh's
    tolerances. G's forward (each conv's halo on the whole-channel slab,
    then its output channels over the model pair) is held to JAX's forward
    on one device, at the same bound: JAX's own ``generate`` on
    make_mesh(2, 2, 2) lies 2.1e-2 from it (and 6.4e-2 on make_mesh(1, 4,
    2); within 1e-8 on meshes with only one of the model and spatial
    axes: scripts/check_jax_mesh_forward.py), while its G and D steps on
    that mesh, whose fakes the same G makes, agree with the port's
    (ROADMAP.md §3)."""
    want, got = both
    if what == "generate":
        assert got["generate3"].shape == (N, 16, 16, 4, 3)
        np.testing.assert_allclose(got["generate3"].numpy(),
                                   want["generate_one"], rtol=2e-4,
                                   atol=1e-5)
    elif what == "g":
        (wl, wg), (gl, gg) = want["g3"], got["g3"]
        for k, v in wl.items():
            np.testing.assert_allclose(gl[k], v, rtol=1e-5, atol=1e-9,
                                       err_msg=k)
        _assert_params(gg, wg, G_TOL)
    else:
        (wl, wg, ws), (gl, gg, gs) = want["d3"], got["d3"]
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        _assert_params(gg, wg, D_TOL)
        _assert_params(gs, ws, STATS_TOL)


def test_three_axes_take_jaxs_device_order(both):
    """Rank r of make_mesh(2, 2, 2) is at (data, model, spatial) where
    JAX's make_mesh(2, 2, 2) puts device r: r = ((d·tp) + m)·s + x."""
    want, got = both
    devices = want["devices3"]
    assert sorted(r for r, *_ in got["coords3"]) == list(range(8))
    for r, d, m, x in got["coords3"]:
        assert devices[d, m, x] == r == (d * 2 + m) * 2 + x

