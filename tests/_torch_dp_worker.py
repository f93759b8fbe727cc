"""Ranks of a gloo group on the CPU for the port's mesh tests.

``spawn(task, world, tmp_path, payload)`` starts ``world`` processes over a
``file://`` store under ``tmp_path``; each joins the group and runs
``TASKS[task](payload)``, which builds its mesh (``payload["axes"]``, the
arguments of ``make_mesh``: every rank on the data axis when absent), and
rank 0's return value comes back. The workers import torch and the port only: the JAX side of a
comparison runs in the test's own process. ``payload`` is pickled with
``torch.save`` (it carries the port's ``Config``).
"""

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gan_sr_wind_field_tpu_torch.parallel import (
    batch_sharding,
    gather_state,
    gather_x,
    halo_exchange,
    init_distributed,
    make_mesh,
    shard_state,
    volume_sharding,
)
from gan_sr_wind_field_tpu_torch.parallel.collectives import gather_rows


def spawn(task: str, world: int, tmp_path, payload=None, timeout=240):
    """Run ``task`` on ``world`` gloo ranks; → rank 0's result. Ranks still
    running after ``timeout`` seconds are killed and the call raises."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    src = os.path.join(tmp, f"{task}_{world}_in.pt")
    out = os.path.join(tmp, f"{task}_{world}_out.pt")
    torch.save(payload, src)
    ctx = mp.start_processes(_main, args=(world, tmp, task, src, out),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    # join returns when any one rank ends: wait for all of them
    while not ctx.join(max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{task} on {world} ranks: over {timeout} s")
    return torch.load(out, weights_only=False)


def _main(rank, world, tmp, task, src, out):
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{tmp}/store_{task}_{world}",
                     rank=rank, world_size=world, timeout_s=120)
    try:
        payload = torch.load(src, weights_only=False)
        result = TASKS[task](payload)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def checksum(state) -> str:
    """A digest of every tensor of a ``GANTrainState``, ``it`` and its
    generator's state: equal digests are equal states, bit for bit."""
    h = hashlib.sha256()
    trees = [state.params_G, state.params_D, state.batch_stats_D,
             state.params_G_ema or {}]
    for opt in (state.opt_state_G, state.opt_state_D):
        trees += [opt.mu, opt.nu, {"count": opt.count}]
    for tree in trees:
        for k, t in tree.items():
            h.update(k.encode())
            h.update(t.detach().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    h.update(str(state.it).encode())
    h.update(state.rng.get_state().numpy().tobytes())
    return h.hexdigest()


def all_equal(mesh, value) -> bool:
    """Whether ``value`` is the same on every rank of the mesh."""
    values = [None] * mesh.ranks
    dist.all_gather_object(values, value, group=mesh.control)
    return all(v == values[0] for v in values)


def whole_grads(gan, state, grads) -> dict:
    """G's gradients by name, gathered whole over a model axis."""
    grads = dict(zip(state.params_G, grads))
    channels = gan._channels
    if channels is None:
        return grads
    from gan_sr_wind_field_tpu_torch.parallel.model import gather_trees

    return gather_trees([grads], state.sharded, channels)[0]


# ----------------------------------------------------------------- tasks
def _gan(cfg, mesh, state0, coords):
    """A trainer on ``mesh`` and ``state0`` placed on it (G cut over a
    model axis)."""
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    gan = WindFieldGAN(cfg, coords, coords, device="cpu", mesh=mesh)
    state = gan.init_state(0, state0["lr_shape"], state0["hr_shape"])
    with torch.no_grad():
        for tree in ("params_G", "params_D", "batch_stats_D"):
            for k, v in getattr(state, tree).items():
                v.copy_(state0[tree][k])
        if state.params_G_ema is not None:
            for k, v in state.params_G_ema.items():
                v.copy_(state0["params_G"][k])
    state.it = state0["it"]
    return gan, shard_state(state, mesh)


def _rows(mesh, batch):
    sl = mesh.rows(batch[0].shape[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a[sl]))
                 for a in batch)


def _d_grads(gan, state, lr, hr, z, it, gen=None):
    """One D step's loss, gradients and moved statistics, without the
    update (as ``tests/test_torch_train_step.py`` takes them), drawing
    from ``gen`` (default the state's generator)."""
    params = {k: v.detach().requires_grad_() for k, v in
              state.params_D.items()}
    stats = {k: v.clone() for k, v in state.batch_stats_D.items()}
    lr, hr, z = gan._cut(lr, hr, z)
    fake = gan._g_forward_nograd(state.params_G, lr, z)
    loss, _, _ = gan._d_loss(params, stats, hr[..., :3], fake, it,
                             state.rng if gen is None else gen, True)
    grads = dict(zip(params, gan._grads(loss, params)))
    value = gan._reduce({"loss": loss})["loss"]
    return float(value), grads, stats


class _SummedGather(torch.autograd.Function):
    """The model axis's gather with the wrong backward: the gathered
    cotangent summed over the model group, then this rank's slice."""

    @staticmethod
    def forward(ctx, y, channels):
        from gan_sr_wind_field_tpu_torch.parallel.model import gather_channels

        ctx.channels, ctx.c = channels, y.shape[-1]
        with torch.no_grad():
            return gather_channels(y, channels)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.channels.group)
        i, c = ctx.channels.index, ctx.c
        return g[..., i * c:(i + 1) * c], None


def _local(gan, where):
    """Make one batch-global place of ``gan``'s step local to each rank's
    rows (a naive data-parallel step there): 'ragan' (the means of D's
    logits), 'physics' (the physics factors' maxima) or 'bn' (D's batch
    statistics); or, on a spatial axis, get one of its places wrong:
    'no_halo' (each slab zero-padded as if it were its own volume),
    'per_sample_once' (D's per-sample terms counted whole on every rank of
    a data row) or 'bn_data_group' (D's batch statistics over the ranks of
    one slab only); or, on a model axis: 'no_pair' (no identity before a
    sharded conv, the gathered cotangent summed over the model group
    instead), 'local_norm' (the clipping norm over this rank's slices
    only) or 'grads_over_model' (G's sharded gradients summed over a group
    that spans the model axis). → the function that undoes it."""
    import gan_sr_wind_field_tpu_torch.models.blocks as blocks_mod
    import gan_sr_wind_field_tpu_torch.train.gan as gan_mod

    mesh = gan.mesh
    if where == "no_halo":
        halo = blocks_mod.halo_exchange
        blocks_mod.halo_exchange = lambda x, w, slab: torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (w, w))
        return lambda: setattr(blocks_mod, "halo_exchange", halo)
    if where == "no_pair":
        pair = blocks_mod.to_model, blocks_mod.gather_channels
        blocks_mod.to_model = lambda x, channels: x
        blocks_mod.gather_channels = _SummedGather.apply

        def undo():
            blocks_mod.to_model, blocks_mod.gather_channels = pair
        return undo
    if where == "local_norm":
        norm = gan_mod.sharded_sq_norm
        gan_mod.sharded_sq_norm = lambda grads, sharded, channels: sum(
            (g.float() ** 2).sum() for g in grads)
        return lambda: setattr(gan_mod, "sharded_sq_norm", norm)
    if where == "grads_over_model":
        real = gan_mod.all_reduce_flat
        gan_mod.all_reduce_flat = lambda tensors, group: real(
            tensors, mesh.world_group)
        return lambda: setattr(gan_mod, "all_reduce_flat", real)
    if where == "per_sample_once":
        gan._mean = lambda t: t.sum() / (
            t.numel() * (mesh.size if t.dim() == 1 else mesh.world))
    elif where == "bn_data_group":
        gan.D.sync_batch_norm(mesh.data_group)
    elif where == "ragan":
        gan._batch_mean = lambda t: t.mean()
    elif where == "physics":
        full = gan_mod.gradient_norm_factors
        gan_mod.gradient_norm_factors = lambda a, b, group=None: full(a, b)
        return lambda: setattr(gan_mod, "gradient_norm_factors", full)
    elif where == "bn":
        gan.D.sync_batch_norm(None)
    return lambda: None


def _grad_norm(gan, state, batch):
    """The global norm of one G step's gradients, as the step clips them
    (``_adam_step`` at learning rate 0 on this throwaway state)."""
    grads = gan.g_grads(state, *batch, 1, state.rng)[2]
    return float(gan._adam_step(state.params_G, grads, state.opt_state_G,
                                0.0, 0.9, 0.0, sharded=state.sharded))


def _feed_augmentation(draws):
    """Make the step's augmentation take ``draws`` (per step: k, fx, fy
    for the global batch, numpy) in turn: JAX's, so that a trajectory with
    ``augment=True`` can be held against JAX's. → the undo."""
    import gan_sr_wind_field_tpu_torch.train.gan as gan_mod

    real, left = gan_mod.augment_draws, list(draws)

    def fed(n, generator, device=None):
        k, fx, fy = (torch.from_numpy(np.asarray(a)) for a in left.pop(0))
        assert k.shape == (n,)
        return k.long(), fx.bool(), fy.bool()

    gan_mod.augment_draws = fed
    return lambda: setattr(gan_mod, "augment_draws", real)


def _mesh_run(mesh, cfg, p, key):
    """G's forward (gathered over x and rows), one G step's losses and
    whole gradients and one D step's on ``mesh``, from ``p``'s state and
    batches; → them under ``key`` + 'generate', 'g', 'd'."""
    gan, state = _gan(cfg, mesh, p["state"], p["coords"])
    lr, _, z = _rows(mesh, p["gen_batch"])
    n = p["gen_batch"][0].shape[0]
    res = {f"generate{key}": gather_rows(gan.generate(state, lr, z),
                                         mesh.data_group, mesh.rows(n), n)}
    losses, grads = gan.g_grads(state, *_rows(mesh, p["g_batch"]), 1,
                                state.rng)[1:]
    res[f"g{key}"] = ({k: float(v) for k, v in losses.items()},
                      whole_grads(gan, state, grads))
    res[f"d{key}"] = _d_grads(gan, state, *_rows(mesh, p["d_batch"]), 0)
    return res


def task_jax_step(p):
    """One G step's gradients, one D step's, val_step, a trajectory (fed
    JAX's augmentation draws with ``aug``) and the negative controls on the
    mesh, from the JAX state; → rank 0's results and whether every rank
    ended bit for bit equal (G gathered whole over a model axis)."""
    mesh = make_mesh(*p.get("axes", (-1,)))
    cfg = p["cfg"]
    gan, state = _gan(cfg, mesh, p["state"], p["coords"])
    res = {}
    if "gen_batch" in p:  # G's forward, gathered over x and rows
        lr, _, z = _rows(mesh, p["gen_batch"])
        n = p["gen_batch"][0].shape[0]
        res["generate"] = gather_rows(gan.generate(state, lr, z),
                                      mesh.data_group, mesh.rows(n), n)
    losses, grads = gan.g_grads(state, *_rows(mesh, p["g_batch"]), 1,
                                state.rng)[1:]
    res["g"] = ({k: float(v) for k, v in losses.items()},
                whole_grads(gan, state, grads))
    res["d"] = _d_grads(gan, state, *_rows(mesh, p["d_batch"]), 0)
    if cfg.training.use_grad_clipping:
        res["g_norm"] = _grad_norm(*_gan(cfg, mesh, p["state"], p["coords"]),
                                   _rows(mesh, p["g_batch"]))
    # the negative controls: one place local (or wrong) at a time
    for where in p.get("controls", ("ragan", "physics", "bn")):
        g2, s2 = _gan(cfg, mesh, p["state"], p["coords"])
        undo = _local(g2, where)
        try:
            if where == "local_norm":
                res[f"local_{where}"] = _grad_norm(
                    g2, s2, _rows(mesh, p["g_batch"]))
            elif where in ("physics", "no_halo", "no_pair",
                           "grads_over_model"):
                res[f"local_{where}"] = whole_grads(g2, s2, g2.g_grads(
                    s2, *_rows(mesh, p["g_batch"]), 1, s2.rng)[2])
            else:
                res[f"local_{where}"] = _d_grads(g2, s2,
                                                 *_rows(mesh, p["d_batch"]),
                                                 0)
        finally:
            undo()
    metrics, stats = gan.val_step(state, *_rows(mesh, p["val_batch"]))
    res["val"] = ({k: float(v) for k, v in metrics.items()},
                  {k: v.clone() for k, v in stats.items()})
    # the trajectory, from a fresh state with the EMA on
    cfg8 = dataclasses.replace(cfg)
    cfg8.training = dataclasses.replace(cfg.training, g_ema_decay=0.999)
    gan8, st = _gan(cfg8, mesh, p["state"], p["coords"])
    undo = _feed_augmentation(p["aug"]) if "aug" in p else (lambda: None)
    steps = []
    try:
        for batch in p["traj"]:
            st, m = gan8.train_step(st, *_rows(mesh, batch),
                                    augment="aug" in p)
            steps.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
    whole = gather_state(st, mesh)
    res["traj"] = (steps, whole.params_G, whole.params_G_ema,
                   {**st.params_D, **st.batch_stats_D})
    res["same_on_every_rank"] = all_equal(mesh, checksum(whole))
    for key in ("2", "3"):  # other meshes of the same ranks
        if f"axes{key}" in p:
            res.update(_mesh_run(make_mesh(*p[f"axes{key}"]), cfg, p, key))
    if "axes3" in p:  # each rank's place: JAX's device order
        m3 = make_mesh(*p["axes3"])
        where = [None] * m3.ranks
        dist.all_gather_object(where, (dist.get_rank(), m3.rank,
                                       m3.model_rank, m3.spatial_rank),
                               group=m3.control)
        res["coords3"] = where
    if "serve" in p:  # WindFieldSR(mesh=): the whole batch on every rank
        from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

        out = WindFieldSR(cfg, p["serve"][0], device="cpu",
                          mesh=mesh).upscale(*p["serve"][1:])
        res["serve"] = out
        res["serve_same"] = all_equal(mesh, hashlib.sha256(
            out.tobytes()).hexdigest())
    return res


def task_port_vs_port(p):
    """With instance noise, noisy labels, dropout and augmentation: a
    validation batch, one G step's gradients, one D step's and four steps
    on the mesh and in one process on the global batches, from one state
    and one generator state; → the largest relative errors by name, the
    D biases' largest difference after the steps, and whether every rank
    ended bit for bit equal."""
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    mesh = make_mesh(*p.get("axes", (-1,)))
    cfg = p["cfg"]
    gan, state = _gan(cfg, mesh, p["state"], p["coords"])
    one = WindFieldGAN(cfg, p["coords"], p["coords"], device="cpu")
    ref = one.init_state(0, p["state"]["lr_shape"], p["state"]["hr_shape"])
    for tree in ("params_G", "params_D", "batch_stats_D", "params_G_ema"):
        with torch.no_grad():
            for k, v in getattr(ref, tree).items():
                v.copy_(p["state"]["params_G" if tree == "params_G_ema"
                                   else tree][k])
    ref.it = state.it
    ref.rng.set_state(state.rng.get_state())
    errs = {}

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)

    def rel_trees(name, a, b, skip=()):
        for k in b:
            if k not in skip:
                errs[f"{name} {k}"] = float((a[k] - b[k]).norm()
                                            / b[k].norm().clamp_min(1e-30))

    def gens():
        return (torch.Generator().manual_seed(7),
                torch.Generator().manual_seed(7))

    batch = p["traj"][0]
    g1, g2 = gens()
    mv, _ = gan.val_step(state, *_rows(mesh, batch), generator=g1)
    mvr, _ = one.val_step(ref, *batch, generator=g2)
    for k, b in mvr.items():
        errs[f"val {k}"] = rel(mv[k], b)
    rel_trees("val stats", state.batch_stats_D, ref.batch_stats_D)
    g1, g2 = gens()
    _, lm, gm = gan.g_grads(state, *_rows(mesh, batch), 2, g1)
    _, lr_, gr = one.g_grads(ref, *(torch.from_numpy(a) for a in batch), 2,
                             g2)
    for k, b in lr_.items():
        errs[f"G loss {k}"] = rel(lm[k], b)
    rel_trees("G grad", whole_grads(gan, state, gm),
              dict(zip(ref.params_G, gr)))
    g1, g2 = gens()
    dm = _d_grads(gan, state, *_rows(mesh, batch), 2, g1)
    dr = _d_grads(one, ref, *(torch.from_numpy(a) for a in batch), 2, g2)
    errs["D loss"] = rel(dm[0], dr[0])
    rel_trees("D grad", dm[1], dr[1], skip=("fc1.bias",))
    errs["D grad fc1.bias abs"] = float((dm[1]["fc1.bias"]
                                         - dr[1]["fc1.bias"]).abs().max())
    rel_trees("D stats", dm[2], dr[2])
    for batch in p["traj"]:
        state, m = gan.train_step(state, *_rows(mesh, batch), augment=True)
        ref, mr = one.train_step(ref, *batch, augment=True)
        for k in ("total", "pix", "xy_gradient", "D_train_loss"):
            errs[f"step {state.it} {k}"] = rel(m[k], mr[k])
    whole = gather_state(state, mesh)
    for tree in ("params_G", "params_G_ema", "batch_stats_D"):
        rel_trees(tree, getattr(whole, tree), getattr(ref, tree))
    biases = [k for k in ref.params_D if k.endswith(".bias")]
    rel_trees("params_D", state.params_D, ref.params_D, skip=biases)
    bias_diff = max(float((state.params_D[k] - ref.params_D[k]).abs().max())
                    for k in biases)
    return dict(errs=errs, bias_diff=bias_diff,
                same_on_every_rank=all_equal(mesh, checksum(whole)),
                same_rng=bool(torch.equal(state.rng.get_state(),
                                          ref.rng.get_state())))


def task_units(p):
    """The mesh's axes and spare ranks, each collective's value and
    gradient, batch norm and the physics factors over the group, the
    placement helpers; → every rank's results, gathered on rank 0."""
    from gan_sr_wind_field_tpu_torch.models.blocks import BatchNorm
    from gan_sr_wind_field_tpu_torch.ops.physics import gradient_norm_factors
    from gan_sr_wind_field_tpu_torch.parallel import collectives as col
    from gan_sr_wind_field_tpu_torch.parallel.mesh import replicate

    rank = dist.get_rank()
    res = {"rank": rank}
    spare = make_mesh(2)
    res["spare"] = (spare.idle, spare.size, spare.rank, spare.shape)
    mesh = make_mesh(-1)
    res["mesh"] = (mesh.size, mesh.rank, mesh.shape,
                   tuple(mesh.device_mesh.mesh_dim_names),
                   mesh.rows(8))
    res["sharding"] = [batch_sharding(mesh)(np.arange(8)).tolist(),
                       volume_sharding(mesh)(torch.arange(4)).tolist()]
    g = mesh.group
    x = torch.from_numpy(p["x"][rank]).requires_grad_()
    s = col.group_sum(x.sum(), g)
    (s * p["w"][0]).backward()
    res["sum"] = (float(s), x.grad.clone())
    x.grad = None
    m = col.group_amax(x, g)
    (m * p["w"][1]).backward()
    res["amax"] = (float(m), x.grad.clone())
    x.grad = None
    mean = col.group_mean(x, g, p["x"].shape[0] * x.shape[0])
    (mean * p["w"][2]).backward()
    res["mean"] = (float(mean), x.grad.clone())
    flat = [torch.full((3,), float(rank)), torch.full((2, 2), 1.0),
            torch.full((2,), rank, dtype=torch.int64)]
    col.all_reduce_flat(flat, g)
    res["flat"] = flat
    rows = mesh.rows(x.shape[0] * mesh.size)
    res["gather"] = col.gather_rows(x.detach(), g, rows,
                                    x.shape[0] * mesh.size)
    # batch norm in train mode over the group, statistics moved
    bn = BatchNorm(p["bn_x"].shape[-1])
    bn.group = g
    bx = torch.from_numpy(p["bn_x"][mesh.rows(p["bn_x"].shape[0])])
    bx.requires_grad_()
    y = bn(bx, train=True, update_stats=True)
    (y * torch.from_numpy(p["bn_w"][mesh.rows(p["bn_x"].shape[0])])
     ).sum().backward()
    res["bn"] = (y.detach(), bx.grad.clone(), bn.scale.grad.clone(),
                 bn.mean.clone(), bn.var.clone())
    # the physics factors' maxima over the group, with their gradient
    sr = torch.from_numpy(p["sr"][mesh.rows(p["sr"].shape[0])])
    sr.requires_grad_()
    hr = torch.from_numpy(p["hr"][mesh.rows(p["hr"].shape[0])])
    f = gradient_norm_factors(hr, sr, g)
    sum(f).backward()
    res["factors"] = ([float(v) for v in f], sr.grad.clone())
    # placement: rank 0's tensors everywhere
    t = [torch.full((4,), float(rank)), torch.full((2,), rank,
                                                   dtype=torch.int32)]
    replicate(mesh, t)
    res["replicate"] = t
    values = [None] * mesh.size
    dist.all_gather_object(values, res, group=mesh.control)
    return values


def task_serve(p):
    """``WindFieldSR(mesh=)``: every rank passes the whole batch (7 fields:
    padded to 8) and gets all of it back; ``upscale_tiled`` on the mesh
    (the host loop); → rank 0's outputs, the one-process ones and whether
    every rank got the same."""
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

    mesh = make_mesh(-1)
    sr = WindFieldSR(p["cfg"], p["params"], device="cpu", mesh=mesh)
    one = WindFieldSR(p["cfg"], p["params"], device="cpu")
    out = sr.upscale(p["lr"], p["z"])
    tiled = sr.upscale_tiled(p["field_lr"], p["field_z"], tile=4,
                             overlap=2, batch=4)
    return dict(out=out, one=one.upscale(p["lr"], p["z"]), tiled=tiled,
                tiled_one=one.upscale_tiled(p["field_lr"], p["field_z"],
                                            tile=4, overlap=2, batch=4),
                same=all_equal(mesh, hashlib.sha256(
                    out.tobytes() + tiled.tobytes()).hexdigest()))


def task_spatial_units(p):
    """On 4 ranks: the meshes with a spatial axis and their groups, the
    halo exchange, every conv shape on slabs, the plain stencil, the
    align-corners resize, batch and instance norm and ``gather_x``, each
    value and gradient on this rank's slab; then ``task_port_vs_port`` on
    ``p["pvp"]``'s mesh. → every rank's unit results, gathered on rank 0,
    and rank 0's port-vs-port result."""
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.models.blocks import (
        RDB,
        BatchNorm,
        ConvLReLU,
        instance_norm,
    )
    from gan_sr_wind_field_tpu_torch.ops.physics import (
        gradient_on_slab,
        wind_field_gradient,
    )
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy
    from gan_sr_wind_field_tpu_torch.parallel.halo import x_window

    rank = dist.get_rank()
    res = {"rank": rank}

    def groups(m):
        return (dist.get_process_group_ranks(m.data_group),
                dist.get_process_group_ranks(m.spatial_group))

    m22 = make_mesh(2, 1, 2)
    res["m22"] = (m22.shape, tuple(m22.device_mesh.mesh_dim_names),
                  m22.rank, m22.spatial_rank, m22.world, m22.lead,
                  groups(m22), dist.get_process_group_ranks(m22.group),
                  volume_sharding(m22)(torch.arange(4 * 8).reshape(
                      4, 8)).tolist())
    spare = make_mesh(1, 1, 2)
    res["spare"] = (spare.idle, spare.shape, spare.spatial_rank)
    mesh = make_mesh(-1, 1, 4)
    res["m14"] = (mesh.shape, mesh.rank, mesh.spatial_rank, groups(mesh))
    slab = mesh.slab()
    cut = slab.cut

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()

    x = leaf(cut(p["x"]))
    for width in (1, 2):
        y = halo_exchange(x, width, slab)
        (y * torch.from_numpy(p["w_halo"][width][rank])).sum().backward()
        res[f"halo{width}"] = (y.detach(), x.grad.clone())
        x.grad = None
    # every conv shape the models use, on slabs; weights from one seed
    for name, kw in p["convs"].items():
        conv = ConvLReLU(**kw, generator=torch.Generator().manual_seed(3))
        x = leaf(cut(p["conv_x"]))
        y = conv(x, slab=slab)
        (y * cut(torch.from_numpy(p["conv_w"][name]))).sum().backward()
        res[f"conv {name}"] = (y.detach(), x.grad.clone(),
                               conv.weight.grad.clone())
    # an RDB of 5 convs on slabs of 4, each conv with its own halo, with a
    # 1³ LFF and with a 3³ one
    for lff in (1, 3):
        rdb = RDB(8, 4, num_convs=5, lff_kern_size=lff,
                  generator=torch.Generator().manual_seed(5))
        x = leaf(cut(p["rdb_x"]))
        y = rdb(x, slab)
        (y * cut(torch.from_numpy(p["rdb_w"]))).sum().backward()
        res[f"rdb lff {lff}"] = (y.detach(), x.grad.clone(),
                                 rdb.convs[1].weight.grad.clone())
    # the plain stencil on haloed slabs
    uvw, zz = leaf(cut(p["uvw"])), cut(torch.from_numpy(p["Z"]))
    g9 = gradient_on_slab(wind_field_gradient, uvw,
                          torch.from_numpy(p["xc"]),
                          torch.from_numpy(p["yc"]), x_window(zz, slab)[0],
                          slab)
    (g9 * cut(torch.from_numpy(p["w9"]))).sum().backward()
    res["stencil"] = (g9.detach(), uvw.grad.clone())
    res["trilinear"] = upsample_trilinear_xy(cut(torch.from_numpy(p["lr"])),
                                             4, slab)
    # batch norm over the mesh, instance norm over the slabs
    bn = BatchNorm(p["bn_x"].shape[-1])
    bn.group = mesh.group
    x = leaf(cut(p["bn_x"]))
    y = bn(x, train=True, update_stats=True)
    (y * cut(torch.from_numpy(p["bn_w"]))).sum().backward()
    res["bn"] = (y.detach(), x.grad.clone(), bn.scale.grad.clone(),
                 bn.mean.clone(), bn.var.clone())
    x = leaf(cut(p["bn_x"]))
    y = instance_norm(x, torch.float32, slab)
    (y * cut(torch.from_numpy(p["bn_w"]))).sum().backward()
    res["instance"] = (y.detach(), x.grad.clone())
    x = leaf(cut(p["x"]))
    y = gather_x(x, slab)
    (y * torch.from_numpy(p["w_gather"][rank])).sum().backward()
    res["gather"] = (y.detach(), x.grad.clone())
    every = [None] * mesh.world
    dist.all_gather_object(every, res, group=mesh.control)
    return dict(units=every, pvp=task_port_vs_port(p["pvp"]))


def task_model_units(p):
    """On 4 ranks: the model meshes and their groups, the Megatron pair
    and its backward, every conv shape with its output channels over the
    model axis, shard_state → gather_state, the rounding draws of a
    sharded bf16 moment; then ``task_port_vs_port`` on ``p["pvp"]``'s
    mesh. → every rank's unit results, gathered on rank 0, and rank 0's
    port-vs-port result."""
    from gan_sr_wind_field_tpu_torch.models.blocks import ConvLReLU
    from gan_sr_wind_field_tpu_torch.ops import sr_cast
    from gan_sr_wind_field_tpu_torch.parallel.model import (
        gather_channels,
        gather_trees,
        to_model,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import (
        WindFieldGAN,
        _round_bf16,
    )

    rank = dist.get_rank()
    res = {"rank": rank}

    def ranks(group):
        return dist.get_process_group_ranks(group)

    mesh = make_mesh(2, 2)
    res["m22"] = (mesh.shape, tuple(mesh.device_mesh.mesh_dim_names),
                  mesh.rank, mesh.model_rank, mesh.world, mesh.ranks,
                  mesh.lead, ranks(mesh.group), ranks(mesh.data_group),
                  ranks(mesh.model_group), ranks(mesh.world_group))
    res["m-1x2"] = make_mesh(-1, 2).shape
    spare = make_mesh(1, 2)
    res["spare"] = (spare.idle, spare.shape, spare.model_rank)
    channels = mesh.channels()

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()

    # the pair around a channel map x @ W: this rank's columns, gathered
    x = leaf(p["pair_x"])
    w = torch.from_numpy(p["pair_w"])
    w_m = channels.cut(w.T).T.clone().requires_grad_()
    y = gather_channels(to_model(x, channels) @ w_m, channels)
    (y * torch.from_numpy(p["pair_c"])).sum().backward()
    res["pair"] = (y.detach(), x.grad.clone(), w_m.grad.clone())
    # every conv shape of G on this rank's output channels
    for name, kw in p["convs"].items():
        conv = ConvLReLU(**kw, generator=torch.Generator().manual_seed(3))
        # a horizontal kernel is (W, O, I, k…): its output channels are
        # dimension 1 (the rule never shards it; the conv takes it all
        # the same), moved to 0 for the cut and the gather
        out = 1 if conv.weight.dim() == 6 else 0
        with torch.no_grad():
            conv.weight.data = channels.cut(
                conv.weight.data.transpose(0, out)).transpose(
                    0, out).contiguous()
            if conv.bias is not None:
                conv.bias.data = channels.cut(conv.bias.data)
        conv.channels = channels
        x = leaf(p["conv_x"][name])
        y = conv(x)
        (y * torch.from_numpy(p["conv_w"][name])).sum().backward()
        grads = {"weight": conv.weight.grad.transpose(0, out)}
        if conv.bias is not None:
            grads["bias"] = conv.bias.grad
        grads = gather_trees([grads], set(grads), channels)[0]
        grads["weight"] = grads["weight"].transpose(0, out)
        res[f"conv {name}"] = (y.detach(), x.grad.clone(), grads)
    # shard_state then gather_state: the whole state back, bit for bit,
    # with bf16 moments (a second dtype in the gather)
    gan = WindFieldGAN(p["cfg_sr"], p["coords"], p["coords"], device="cpu",
                       mesh=mesh)
    whole = gan.init_state(5, p["lr_shape"], p["hr_shape"])
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for tree in (whole.opt_state_G.mu, whole.opt_state_G.nu):
            for v in tree.values():
                v.copy_(torch.randn(v.shape, generator=gen))
    whole_g = {k: v.clone() for k, v in whole.params_G.items()}
    before = {f"{name} {k}": v.clone() for name, tree in (
        ("G", whole.params_G), ("EMA", whole.params_G_ema),
        ("mu", whole.opt_state_G.mu), ("nu", whole.opt_state_G.nu))
        for k, v in tree.items()}
    state = shard_state(whole, mesh)
    res["sharded"] = (sorted(state.sharded),
                      tuple(state.params_G["feature_conv.weight"].shape),
                      tuple(state.opt_state_G.mu["hr_conv1.weight"].shape))
    back = gather_state(state, mesh)
    after = {f"{name} {k}": v for name, tree in (
        ("G", back.params_G), ("EMA", back.params_G_ema),
        ("mu", back.opt_state_G.mu), ("nu", back.opt_state_G.nu))
        for k, v in tree.items()}
    res["round_trip"] = (not back.sharded,
                         sorted(k for k in before
                                if not torch.equal(before[k], after[k])))
    # a sharded moment's rounding bits: drawn whole and cut
    m = torch.from_numpy(p["moment"])
    g1, g2 = (torch.Generator().manual_seed(11) for _ in range(2))
    res["sr"] = torch.equal(_round_bf16(channels.cut(m), g1, channels),
                            channels.cut(sr_cast.stochastic_round_bf16(m,
                                                                       g2)))
    # int8 serving on a model mesh raises, as JAX's does
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

    sr = WindFieldSR(p["cfg_sr"], whole_g, device="cpu", mesh=mesh)
    for name in ("quantize", "quantize_trunk"):
        try:
            getattr(sr, name)(p["calib_lr"])
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    every = [None] * mesh.ranks
    dist.all_gather_object(every, res, group=mesh.control)
    return dict(units=every, pvp=task_port_vs_port(p["pvp"]))


TASKS = {"jax_step": task_jax_step, "port_vs_port": task_port_vs_port,
         "units": task_units, "serve": task_serve,
         "spatial_units": task_spatial_units,
         "model_units": task_model_units}
