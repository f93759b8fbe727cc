"""The data, model and spatial axes over a group of processes, one card
each (the JAX package's ``parallel/``): ``make_mesh`` and the placement
helpers in ``mesh.py``, the step's collectives in ``collectives.py``, the
spatial axis's halo exchange and gather in ``halo.py``, the model axis's
sharding rule and channel gather in ``model.py``."""

from gan_sr_wind_field_tpu_torch.parallel.halo import (
    Slab,
    gather_x,
    halo_exchange,
)
from gan_sr_wind_field_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gather_state,
    init_distributed,
    make_mesh,
    pad_batch_to,
    replicate,
    shard_params,
    shard_state,
    volume_sharding,
)
from gan_sr_wind_field_tpu_torch.parallel.model import Channels

__all__ = [
    "Channels",
    "Mesh",
    "Slab",
    "batch_sharding",
    "gather_state",
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
