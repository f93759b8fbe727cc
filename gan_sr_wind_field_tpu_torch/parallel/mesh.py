"""The data, model and spatial axes of a group of processes, one card each.

Counterpart of ``gan_sr_wind_field_tpu/parallel/mesh.py``. JAX builds one
program over a mesh of devices and GSPMD partitions it from sharding
annotations; the port runs one process per card (``torchrun``), each with
the whole model, and the collectives that GSPMD would insert are written
out (``parallel/collectives.py``, ``parallel/halo.py``,
``parallel/model.py``):

- **data axis**: the batch dimension of LR, HR and Z is split over the
  data axis; the gradients are summed over the ranks of one model index
  once per step, and the places where the loss reads the whole batch (the
  relativistic-average means of D's logits, the physics losses' maxima and
  D's batch statistics in train mode) take values over those ranks;
- **model axis**: each rank of a model group holds its output channels of
  every leaf of G that JAX's ``_param_spec`` shards (``parallel/
  model.py``); a sharded conv convolves the whole input with its slice and
  a gather gives every model rank the whole output, so everything between
  convs, D and the loss run replicated. A model rank is a replica of the
  loss, not a share of it;
- **spatial axis**: each rank of a data row holds one x slab of every
  volume, ``[i·X/s, (i+1)·X/s)``; every conv and the stencil pair take the
  x planes they read across the slab's edges from the neighbours (a halo
  exchange), and D gathers its features along x once its slabs stop
  halving evenly. The LR x extent must divide over the axis (GSPMD would
  pad; ``ROADMAP.md`` §3);
- every random draw that depends on the batch (augmentation, dropout
  masks, labels, instance noise) is made at the global batch's shape from
  the state's generator, which every rank holds in the same state, and each
  rank keeps its rows and its slab: a run on a mesh is the one-process run
  on the global batch, up to the order of summation.

A ``Mesh`` wraps a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")``, or ``("data", "model", "spatial")`` with a spatial
axis, as JAX names them. Ranks are in JAX's row-major device order over
those axes: rank ``r = ((d·tp) + m)·s + x`` is data row d, model index m
and x slab x. It keeps these process groups apart, the first three taken
within one model index: ``group``, the data × spatial ranks (gradients, D's
batch statistics, the physics maxima, the metrics); ``data_group``, the
ranks of one x slab (the relativistic-average means over rows);
``spatial_group``, the ranks of one data row (halos and gathers);
``model_group``, the ``tp`` ranks of one data row and one x slab (G's
channel gathers); ``world_group``, every rank of the mesh (the first
rank's state to the others, the replicated leaves' gradients). A mesh
smaller than the world takes its first ranks; the others are idle
(``Mesh.idle``) and run no step, as JAX's spare chips do
(``run.py:235-244``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gan_sr_wind_field_tpu_torch.parallel.halo import Slab
from gan_sr_wind_field_tpu_torch.parallel.model import (
    Channels,
    gather_trees,
    shard_tree,
    sharded_keys,
)

# a collective that waits longer than this fails instead of hanging; it
# must exceed the longest stretch one rank works alone (rank 0's
# validation sweep and checkpoint save)
DEFAULT_TIMEOUT_S = 1800.0


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size_from_env() -> int:
    """The process count ``torchrun`` announces (``WORLD_SIZE``; 1 when
    started otherwise)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def default_device(device=None) -> torch.device:
    """This process's device: ``device`` if given, else the card of its
    ``LOCAL_RANK`` (0 when started without ``torchrun``)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_distributed(device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the default process group: NCCL for a CUDA device, gloo for the
    CPU. Rank, world size and the rendezvous come from ``torchrun``'s
    environment unless given. A collective that waits ``timeout_s`` fails.
    Returns the process's device (``default_device``), made current."""
    device = default_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if rank is not None:
        kw = dict(rank=rank, world_size=world_size)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return device


@dataclass(frozen=True)
class Mesh:
    """The data axis of ``size`` rows, the model axis of ``model`` channel
    shares and the spatial axis of ``spatial`` slabs over the default
    group's first ``size · model · spatial`` ranks: the ``DeviceMesh``
    over them (``None`` on an idle rank), this process's index on each
    axis (``rank`` on the data axis, ``model_rank`` and ``spatial_rank``;
    ``None`` when idle) and the groups the module docstring names.
    ``control`` is a gloo group of the same ranks for host-side agreement
    (flags, barriers), which never waits on the card."""

    device_mesh: object
    group: object
    control: object
    size: int
    rank: Optional[int]
    spatial: int = 1
    spatial_rank: Optional[int] = None
    data_group: object = None
    spatial_group: object = None
    model: int = 1
    model_rank: Optional[int] = None
    model_group: object = None
    world_group: object = None

    @property
    def shape(self) -> dict:
        """The axes' sizes, as JAX's ``Mesh.shape``."""
        if self.spatial > 1:
            return {"data": self.size, "model": self.model,
                    "spatial": self.spatial}
        return {"data": self.size, "model": self.model}

    @property
    def world(self) -> int:
        """The shares of the loss: data × spatial. A model rank is a
        replica of its model index's loss, not a share of it."""
        return self.size * self.spatial

    @property
    def ranks(self) -> int:
        """The mesh's ranks: data × model × spatial."""
        return self.size * self.model * self.spatial

    @property
    def idle(self) -> bool:
        return self.rank is None

    @property
    def lead(self) -> bool:
        """Whether this is the mesh's first rank (data row 0, model index
        0, slab 0): the one that writes."""
        return self.rank == 0 and not self.spatial_rank \
            and not self.model_rank

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``; ``n`` must divide
        over the data axis."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over a data "
                             f"axis of {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def slab(self):
        """This rank's place on the spatial axis (``parallel/halo.py``),
        or ``None`` without a spatial axis."""
        if self.spatial == 1:
            return None
        return Slab(self.spatial_group, self.spatial_rank, self.spatial)

    def channels(self):
        """This rank's place on the model axis (``parallel/model.py``), or
        ``None`` without a model axis."""
        if self.model == 1:
            return None
        return Channels(self.model_group, self.model_rank, self.model)

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (host only)."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.control)


def rank_at(d: int, m: int, x: int, tp: int, s: int) -> int:
    """The rank of data row ``d``, model index ``m`` and x slab ``x``:
    JAX's row-major device order over ``(data, model, spatial)``."""
    return (d * tp + m) * s + x


def make_mesh(data_parallel: int = -1, tensor_parallel: int = 1,
              spatial_parallel: int = 1, devices=None) -> Mesh:
    """('data', 'model'[, 'spatial']) mesh over the default process group
    (joined with ``init_distributed``), ranks in JAX's row-major order.
    ``data_parallel = -1`` takes every rank the model and spatial axes
    leave (``world // (tp·s)``, as JAX ``make_mesh`` does); fewer take the
    first ranks, and the rest are idle. ``devices`` is this process's
    device, whose type the ``DeviceMesh`` takes (default:
    ``default_device()``). A mesh of more ranks than run raises
    ``ValueError``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call init_distributed() first (under torchrun)")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device = default_device(devices)
    world = dist.get_world_size()
    tp, s = int(tensor_parallel), int(spatial_parallel)
    if tp < 1 or s < 1:
        raise ValueError(f"mesh axes must be >= 1, have model {tp}, "
                         f"spatial {s}")
    d = (max(1, world // (tp * s)) if data_parallel == -1
         else int(data_parallel))
    n = d * tp * s
    if not 1 <= n <= world:
        raise ValueError(f"mesh {d}x{tp}x{s} needs {n} ranks, have {world} "
                         f"(torchrun --nproc_per_node={n})")
    shape, names = ((d, tp, s), ("data", "model", "spatial")) if s > 1 \
        else ((d, tp), ("data", "model"))
    if n == world:
        dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    else:
        dm = DeviceMesh(device.type, torch.arange(n).reshape(shape),
                        mesh_dim_names=names)
    # every rank takes part in creating the groups, in one order
    control = dist.new_group(list(range(n)), backend="gloo")
    whole = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    # the data x spatial ranks of each model index
    by_model = [dist.new_group([rank_at(i, m, x, tp, s) for i in range(d)
                                for x in range(s)])
                if tp > 1 and s > 1 else None for m in range(tp)]
    coord = dm.get_coordinate()
    if coord is None:
        logging.getLogger("status").warning(
            f"rank {dist.get_rank()} is idle: the mesh has {n} of "
            f"{world} ranks")
        return Mesh(None, None, None, d, None, s, model=tp)
    data_group = dm.get_group("data")
    m = coord[1]
    model_group = dm.get_group("model") if tp > 1 else None
    if s == 1:
        group = data_group
        spatial_rank = spatial_group = None
    else:
        group = by_model[m] if tp > 1 else whole
        spatial_rank, spatial_group = coord[2], dm.get_group("spatial")
    return Mesh(dm, group, control, d, coord[0], s, spatial_rank,
                data_group, spatial_group, tp, m, model_group,
                whole if tp > 1 else group)


def data_axis(parallel, world: int, batch: int) -> tuple:
    """The (data, model, spatial) axes for the ``[PARALLEL]`` section
    ``parallel`` on ``world`` ranks and a global batch of ``batch``:
    ``tensor_parallel`` and ``spatial_parallel`` as they stand, and
    ``data_parallel`` (-1: every rank the model and spatial axes leave,
    ``world // (tp·s)``) shrunk to the largest divisor of the batch, with
    JAX's warning (``run.py:233-242``). Raises ``ValueError`` for more
    ranks than run."""
    tp = max(1, int(parallel.tensor_parallel))
    s = max(1, int(parallel.spatial_parallel))
    n = (max(1, world // (tp * s)) if parallel.data_parallel == -1
         else parallel.data_parallel)
    if not 1 <= n * tp * s <= world:
        raise ValueError(
            f"[PARALLEL] data_parallel = {parallel.data_parallel} x "
            f"tensor_parallel = {tp} x spatial_parallel = {s} needs "
            f"{n * tp * s} ranks, have {world} "
            f"(torchrun --nproc_per_node={n * tp * s})")
    if batch % n:
        dp = n
        while batch % dp:
            dp -= 1
        logging.getLogger("status").warning(
            f"batch {batch} not divisible by data axis {n}; using "
            f"data={dp}")
        n = dp
    return n, tp, s


def batch_sharding(mesh: Mesh):
    """Shard the leading (batch) axis over 'data': a function from a global
    batch (array or tensor) to this rank's rows."""
    return lambda batch: batch[mesh.rows(batch.shape[0])]


def volume_sharding(mesh: Mesh):
    """Shard (N, X, Y, Z, C) volumes: the batch over 'data', then x over
    'spatial' (``[i·X/s, (i+1)·X/s)``); ``batch_sharding`` without a
    spatial axis. X must divide over the axis."""
    rows = batch_sharding(mesh)
    slab = mesh.slab()
    if slab is None:
        return rows
    return lambda batch: slab.cut(rows(batch))


def replicate(mesh: Mesh, tensors) -> None:
    """Broadcast ``tensors`` (a list, or a dict's values) from the mesh's
    first rank to every rank of it, in place: one flat broadcast per
    dtype."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    src = dist.get_global_rank(mesh.world_group, 0)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=src, group=mesh.world_group)
        with torch.no_grad():
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def shard_params(params, mesh: Mesh):
    """G's parameter tree (whole tensors) placed on ``mesh``: each leaf
    JAX's ``_param_spec`` shards cut to this rank's output channels
    (``parallel/model.py``), the rest as it is; the tree itself without a
    model axis."""
    channels = None if mesh is None else mesh.channels()
    if channels is None:
        return params
    return shard_tree(params, sharded_keys(params, mesh.model), channels)


def _g_trees(state) -> list:
    """G's trees of a state: its parameters, the EMA, Adam's moments."""
    opt = state.opt_state_G
    return [state.params_G, state.params_G_ema or {}, opt.mu, opt.nu]


def shard_state(state, mesh: Mesh):
    """Make ``state`` (a whole ``GANTrainState``, as one process holds
    it) the first rank's on every rank, in place: every tensor (G, D, D's
    statistics, the frozen D, the EMA, both Adam states), ``it`` and the
    generator's state. On a model axis G's parameters, EMA and Adam
    moments are then cut to this rank's output channels of each leaf JAX
    shards (``state.sharded`` names them; JAX keeps the moments whole, the
    same function). D and everything else stay whole. Returns it."""
    if state.sharded:
        raise ValueError("shard_state takes a whole state; this one is "
                         "sharded already")
    trees = [state.params_G, state.params_D, state.batch_stats_D,
             state.params_D_frozen, state.params_G_ema or {}]
    tensors = [t for tree in trees for t in tree.values()]
    for opt in (state.opt_state_G, state.opt_state_D):
        tensors += [opt.count, *opt.mu.values(), *opt.nu.values()]
    replicate(mesh, tensors)
    host = [state.it, state.rng.get_state()]
    dist.broadcast_object_list(host, src=dist.get_global_rank(mesh.control,
                                                               0),
                               group=mesh.control)
    state.it = host[0]
    state.rng.set_state(host[1])
    channels = mesh.channels()
    if channels is not None:
        keys = sharded_keys(state.params_G, mesh.model)
        g, ema, mu, nu = (shard_tree(t, keys, channels)
                          for t in _g_trees(state))
        state.params_G, state.opt_state_G.mu, state.opt_state_G.nu = g, mu, nu
        if state.params_G_ema is not None:
            state.params_G_ema = ema
        state.sharded = keys
    return state


def gather_state(state, mesh: Mesh):
    """The whole state of a sharded one (``shard_state``'s on a model
    axis): a new ``GANTrainState`` whose G parameters, EMA and Adam
    moments are gathered over the model group (one all_reduce per dtype),
    the one-process format that checkpoints, packs and validation take.
    Its other trees are ``state``'s own tensors. A collective of the model
    group: every rank calls it. A whole state comes back as it is."""
    if not state.sharded:
        return state
    g, ema, mu, nu = gather_trees(_g_trees(state), state.sharded,
                                  mesh.channels())
    opt = dataclasses.replace(state.opt_state_G, mu=mu, nu=nu)
    return dataclasses.replace(
        state, params_G=g, opt_state_G=opt, sharded=frozenset(),
        params_G_ema=None if state.params_G_ema is None else ema)


def pad_batch_to(batch: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple of the data-axis size with
    copies of the first sample; → (padded, the original count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[:1], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
