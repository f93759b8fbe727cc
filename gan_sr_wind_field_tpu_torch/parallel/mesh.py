"""The data and spatial axes of a group of processes, one card each.

Counterpart of ``gan_sr_wind_field_tpu/parallel/mesh.py``. JAX builds one
program over a mesh of devices and GSPMD partitions it from sharding
annotations; the port runs one process per card (``torchrun``), each with
the whole model, and the collectives that GSPMD would insert are written
out (``parallel/collectives.py``, ``parallel/halo.py``):

- **data axis**: the batch dimension of LR, HR and Z is split over the
  data axis; the gradients are summed over the mesh once per step, and
  the places where the loss reads the whole batch (the
  relativistic-average means of D's logits, the physics losses' maxima and
  D's batch statistics in train mode) take mesh-wide values;
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
  on the global batch, up to the order of summation;
- the **model** axis is not ported (``ROADMAP.md`` §1): ``make_mesh``
  raises ``NotImplementedError`` for it.

A ``Mesh`` wraps a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")``, or ``("data", "model", "spatial")`` with a spatial
axis, as JAX names them. Ranks are data-major, as JAX's
``create_device_mesh`` lays them out: rank r is data row r // s at x slab
r % s. It keeps three process groups apart: ``group``, the mesh's world
(gradients, D's batch statistics, the physics maxima, the metrics);
``data_group``, the ranks of one x slab (the relativistic-average means
over rows); ``spatial_group``, the ranks of one data row (halos and
gathers). A mesh smaller than the world takes its first ranks; the others
are idle (``Mesh.idle``) and run no step, as JAX's spare chips do
(``run.py:235-244``).
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gan_sr_wind_field_tpu_torch.parallel.halo import Slab

_NOT_PORTED = "is not ported yet (ROADMAP.md §1: {})"
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
    """The data axis of ``size`` rows and the spatial axis of ``spatial``
    slabs over the default group's first ``size · spatial`` ranks: the
    ``DeviceMesh`` over them (``None`` on an idle rank), this process's
    index on each axis (``rank`` on the data axis, ``spatial_rank`` on the
    spatial one; ``None`` when idle) and the three groups the module
    docstring names. ``control`` is a gloo group of the same ranks for
    host-side agreement (flags, barriers), which never waits on the
    card."""

    device_mesh: object
    group: object
    control: object
    size: int
    rank: Optional[int]
    spatial: int = 1
    spatial_rank: Optional[int] = None
    data_group: object = None
    spatial_group: object = None

    @property
    def shape(self) -> dict:
        """The axes' sizes, as JAX's ``Mesh.shape``."""
        if self.spatial > 1:
            return {"data": self.size, "model": 1, "spatial": self.spatial}
        return {"data": self.size, "model": 1}

    @property
    def world(self) -> int:
        """The mesh's ranks: data × spatial."""
        return self.size * self.spatial

    @property
    def idle(self) -> bool:
        return self.rank is None

    @property
    def lead(self) -> bool:
        """Whether this is the mesh's first rank (data row 0, slab 0): the
        one that writes."""
        return self.rank == 0 and not self.spatial_rank

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

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (host only)."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.control)


def _no_model_axis(tensor_parallel: int) -> None:
    """Raise for the axis not ported yet."""
    if tensor_parallel > 1:
        raise NotImplementedError(
            f"tensor_parallel = {tensor_parallel}: the model axis "
            + _NOT_PORTED.format("the model axis, after the spatial axis"))


def make_mesh(data_parallel: int = -1, tensor_parallel: int = 1,
              spatial_parallel: int = 1, devices=None) -> Mesh:
    """('data', 'model'[, 'spatial']) mesh over the default process group
    (joined with ``init_distributed``), data-major. ``data_parallel = -1``
    takes every rank the spatial axis leaves; fewer take the first ranks,
    and the rest are idle. ``devices`` is this process's device, whose
    type the ``DeviceMesh`` takes (default: ``default_device()``).
    ``tensor_parallel`` above 1 raises ``NotImplementedError``."""
    _no_model_axis(tensor_parallel)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call init_distributed() first (under torchrun)")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device = default_device(devices)
    world = dist.get_world_size()
    s = int(spatial_parallel)
    d = max(1, world // s) if data_parallel == -1 else int(data_parallel)
    n = d * s
    if s < 1 or not 1 <= n <= world:
        raise ValueError(f"mesh {d}x1x{s} needs {n} ranks, have {world}")
    shape, names = ((d, 1, s), ("data", "model", "spatial")) if s > 1 \
        else ((d, 1), ("data", "model"))
    if n == world:
        dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    else:
        dm = DeviceMesh(device.type, torch.arange(n).reshape(shape),
                        mesh_dim_names=names)
    # every rank takes part in creating the groups
    control = dist.new_group(list(range(n)), backend="gloo")
    whole = (None if s == 1 else dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    coord = dm.get_coordinate()
    if coord is None:
        logging.getLogger("status").warning(
            f"rank {dist.get_rank()} is idle: the mesh has {n} of "
            f"{world} ranks")
        return Mesh(None, None, None, d, None, s)
    data_group = dm.get_group("data")
    if s == 1:
        return Mesh(dm, data_group, control, d, coord[0], 1, None,
                    data_group)
    return Mesh(dm, whole, control, d, coord[0], s, coord[2], data_group,
                dm.get_group("spatial"))


def data_axis(parallel, world: int, batch: int) -> tuple:
    """The (data, spatial) axes for the ``[PARALLEL]`` section
    ``parallel`` on ``world`` ranks and a global batch of ``batch``:
    ``spatial_parallel`` as it stands, and ``data_parallel`` (-1: every
    rank the spatial axis leaves) shrunk to the largest divisor of the
    batch, with JAX's warning (``run.py:233-242``). Raises
    ``NotImplementedError`` for the model axis and ``ValueError`` for more
    ranks than run."""
    _no_model_axis(parallel.tensor_parallel)
    s = max(1, int(parallel.spatial_parallel))
    n = (max(1, world // s) if parallel.data_parallel == -1
         else parallel.data_parallel)
    if not 1 <= n * s <= world:
        raise ValueError(
            f"[PARALLEL] data_parallel = {parallel.data_parallel} x "
            f"spatial_parallel = {s} needs {n * s} ranks, have {world} "
            f"(torchrun --nproc_per_node={n * s})")
    if batch % n:
        dp = n
        while batch % dp:
            dp -= 1
        logging.getLogger("status").warning(
            f"batch {batch} not divisible by data axis {n}; using "
            f"data={dp}")
        n = dp
    return n, s


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
    """Broadcast ``tensors`` (a list, or a dict's values) from the axis's
    first rank, in place: one flat broadcast per dtype."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    src = dist.get_global_rank(mesh.group, 0)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=src, group=mesh.group)
        with torch.no_grad():
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def shard_params(params, mesh: Mesh):
    """Place a parameter tree: the identity at ``tensor_parallel = 1``, the
    only model axis the port has."""
    return params


def shard_state(state, mesh: Mesh):
    """Make ``state`` (a ``GANTrainState``) the first rank's on every rank,
    in place: every tensor (G, D, D's statistics, the frozen D, the EMA,
    both Adam states), ``it`` and the generator's state. Returns it."""
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
    return state


def pad_batch_to(batch: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple of the data-axis size with
    copies of the first sample; → (padded, the original count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[:1], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
