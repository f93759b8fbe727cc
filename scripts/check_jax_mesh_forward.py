"""Print how far the JAX package's ``WindFieldGAN.generate`` on each CPU
mesh lies from its forward on one device, at the tiny geometry of the
port's tests (``tests/_torch_tiny.py``), from one seeded state and batch.

    python scripts/check_jax_mesh_forward.py

It runs on the CPU with 8 virtual devices. The port's forward on
make_mesh(2, 2, 2) is held to the one-device forward in
``tests/test_torch_spatial.py::test_all_three_axes_match_jax``; this
script shows why that test does not hold it to JAX's own forward on that
mesh.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_tiny import (  # noqa: E402
    COORDS,
    HR_SHAPE,
    LR_SHAPE,
    make_batch,
    tiny_cfg,
)
from gan_sr_wind_field_tpu.parallel import (  # noqa: E402
    make_mesh,
    shard_state,
    volume_sharding,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN  # noqa: E402


def main():
    one = WindFieldGAN(tiny_cfg(False), COORDS, COORDS)
    state = one.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    lr, _, z = make_batch(5, n=4)
    ref = np.asarray(one.generate(state.params_G, lr, z))
    for axes in [(2, 1, 4), (2, 2, 1), (4, 2, 1), (1, 2, 4), (2, 2, 2),
                 (1, 4, 2)]:
        mesh = make_mesh(*axes)
        gan = WindFieldGAN(tiny_cfg(False), COORDS, COORDS, mesh=mesh)
        st = shard_state(jax.tree.map(jnp.copy, state), mesh)
        vs = volume_sharding(mesh)
        out = np.asarray(gan.generate(st.params_G, jax.device_put(lr, vs),
                                      jax.device_put(z, vs)))
        print(f"make_mesh{axes}: generate vs one device, max abs "
              f"{float(np.abs(out - ref).max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
