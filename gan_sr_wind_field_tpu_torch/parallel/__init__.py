"""The data and spatial axes over a group of processes, one card each (the
JAX package's ``parallel/``): ``make_mesh`` and the placement helpers in
``mesh.py``, the step's collectives in ``collectives.py``, the spatial
axis's halo exchange and gather in ``halo.py``."""

from gan_sr_wind_field_tpu_torch.parallel.halo import (
    Slab,
    gather_x,
    halo_exchange,
)
from gan_sr_wind_field_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    pad_batch_to,
    replicate,
    shard_params,
    shard_state,
    volume_sharding,
)

__all__ = [
    "Mesh",
    "Slab",
    "batch_sharding",
    "gather_x",
    "halo_exchange",
    "init_distributed",
    "make_mesh",
    "pad_batch_to",
    "replicate",
    "shard_params",
    "shard_state",
    "volume_sharding",
]
