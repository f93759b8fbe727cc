"""The data axis of a group of processes, one card each.

Counterpart of ``gan_sr_wind_field_tpu/parallel/mesh.py``. JAX builds one
program over a mesh of devices and GSPMD partitions it from sharding
annotations; the port runs one process per card (``torchrun``), each with
the whole model and its own rows of every batch, and the collectives that
GSPMD would insert are written out (``parallel/collectives.py``):

- **data axis**: the batch dimension of LR, HR and Z is split over the
  group's ranks; the gradients are summed over the group once per step,
  and the three places where the loss reads the whole batch (the
  relativistic-average means of D's logits, the physics losses' maxima and
  D's batch statistics in train mode) take group-wide values;
- every random draw that depends on the batch (augmentation, dropout
  masks, labels, instance noise) is made at the global batch's shape from
  the state's generator, which every rank holds in the same state, and each
  rank keeps its rows: a run on a mesh is the one-process run on the
  global batch, up to the order of summation;
- the **model** and **spatial** axes are not ported (``ROADMAP.md`` §1):
  ``make_mesh`` raises ``NotImplementedError`` for them.

A ``Mesh`` wraps a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")``, as JAX names them, the data axis's process group and
this process's place on it. A data axis smaller than the world takes its
first ranks; the others are idle (``Mesh.idle``) and run no step, as JAX's
spare chips do (``run.py:235-244``).
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
    """The data axis: ``size`` ranks (the default group's first), the
    ``DeviceMesh`` over them (``None`` on an idle rank), the axis's process
    group and this process's index on it (``None`` when idle). ``control``
    is a gloo group of the same ranks for host-side agreement (flags,
    barriers), which never waits on the card."""

    device_mesh: object
    group: object
    control: object
    size: int
    rank: Optional[int]

    @property
    def shape(self) -> dict:
        """The axes' sizes, as JAX's ``Mesh.shape``."""
        return {"data": self.size, "model": 1}

    @property
    def idle(self) -> bool:
        return self.rank is None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``; ``n`` must divide
        over the axis."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over a data "
                             f"axis of {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (host only)."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.control)


def _data_axis_only(tensor_parallel: int, spatial_parallel: int) -> None:
    """Raise for the axes not ported yet."""
    if spatial_parallel > 1:
        raise NotImplementedError(
            f"spatial_parallel = {spatial_parallel}: the spatial axis "
            + _NOT_PORTED.format("the spatial axis: a halo exchange around "
                                 "every conv and stencil"))
    if tensor_parallel > 1:
        raise NotImplementedError(
            f"tensor_parallel = {tensor_parallel}: the model axis "
            + _NOT_PORTED.format("the model axis, after the spatial axis"))


def make_mesh(data_parallel: int = -1, tensor_parallel: int = 1,
              spatial_parallel: int = 1, devices=None) -> Mesh:
    """('data', 'model') mesh over the default process group (joined with
    ``init_distributed``). ``data_parallel = -1`` takes every rank; fewer
    take the first ranks, and the rest are idle. ``devices`` is this
    process's device, whose type the ``DeviceMesh`` takes (default:
    ``default_device()``). ``tensor_parallel``
    or ``spatial_parallel`` above 1 raise ``NotImplementedError``."""
    _data_axis_only(tensor_parallel, spatial_parallel)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call init_distributed() first (under torchrun)")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device = default_device(devices)
    world = dist.get_world_size()
    n = world if data_parallel == -1 else int(data_parallel)
    if not 1 <= n <= world:
        raise ValueError(f"mesh {n}x1 needs {n} ranks, have {world}")
    if n == world:
        dm = init_device_mesh(device.type, (n, 1),
                              mesh_dim_names=("data", "model"))
    else:
        dm = DeviceMesh(device.type, torch.arange(n).reshape(n, 1),
                        mesh_dim_names=("data", "model"))
    # every rank takes part in creating the control group
    control = dist.new_group(list(range(n)), backend="gloo")
    coord = dm.get_coordinate()
    if coord is None:
        logging.getLogger("status").warning(
            f"rank {dist.get_rank()} is idle: the data axis has {n} of "
            f"{world} ranks")
        return Mesh(None, None, None, n, None)
    return Mesh(dm, dm.get_group("data"), control, n, coord[0])


def data_axis(parallel, world: int, batch: int) -> int:
    """The data axis for the ``[PARALLEL]`` section ``parallel`` on
    ``world`` ranks and a global batch of ``batch``: ``data_parallel``
    (-1: every rank) shrunk to the largest divisor of the batch, with JAX's
    warning (``run.py:233-242``). Raises ``NotImplementedError`` for the
    model and spatial axes and ``ValueError`` for more ranks than run."""
    _data_axis_only(parallel.tensor_parallel, parallel.spatial_parallel)
    n = world if parallel.data_parallel == -1 else parallel.data_parallel
    if not 1 <= n <= world:
        raise ValueError(
            f"[PARALLEL] data_parallel = {parallel.data_parallel} needs "
            f"{n} ranks, have {world} (torchrun --nproc_per_node={n})")
    if batch % n:
        dp = n
        while batch % dp:
            dp -= 1
        logging.getLogger("status").warning(
            f"batch {batch} not divisible by data axis {n}; using "
            f"data={dp}")
        n = dp
    return n


def batch_sharding(mesh: Mesh):
    """Shard the leading (batch) axis over 'data': a function from a global
    batch (array or tensor) to this rank's rows."""
    return lambda batch: batch[mesh.rows(batch.shape[0])]


def volume_sharding(mesh: Mesh):
    """(N, X, Y, Z, C) volumes over 'data' (the spatial axis is not
    ported): ``batch_sharding``."""
    return batch_sharding(mesh)


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
