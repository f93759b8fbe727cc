"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Imports nothing of JAX, so it runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Each test skips where there is no card.
"""

import pytest
import torch

from gan_sr_wind_field_tpu_torch.models.blocks import RRDB
from gan_sr_wind_field_tpu_torch.ops import rdb_trunk
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    rrdb_trunk,
    rrdb_trunk_reference,
)


@pytest.fixture
def cuda_device():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("nf,gc,num_convs,shape", [
    (8, 4, 3, (2, 4, 3, 5)),      # channels below one 32-wide slice
    (40, 12, 5, (1, 5, 3, 7)),    # slices straddling the state/growth split
    (128, 32, 5, (2, 16, 16, 10)),  # the served geometry
])
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch, dtype,
                                              tol, nf, gc, num_convs, shape):
    # the plain version is the float32 yardstick: no TF32 in its convs
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(nf + gc)
    rrdbs = [RRDB(nf, gc, num_convs=num_convs, init_scale=1.0,
                  generator=gen) for _ in range(2)]
    for r in rrdbs:
        for rdb in r.rdbs:
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(*shape, nf, generator=gen)
    packed = pack_trunk_weights(rrdbs, dtype, cuda_device)
    x_d = x.to(cuda_device, dtype)
    before = rdb_trunk.launches
    got = rrdb_trunk(packed, x_d, gc=gc, num_convs=num_convs)
    torch.cuda.synchronize()
    assert rdb_trunk.launches == before + 1
    want = rrdb_trunk_reference(
        pack_trunk_weights(rrdbs, torch.float32, cuda_device),
        x_d.float(), gc=gc, num_convs=num_convs,
    )
    inc, inc_ref = (got.float() - x_d.float()), (want - x_d.float())
    err = (torch.linalg.vector_norm(inc - inc_ref)
           / torch.linalg.vector_norm(inc_ref)).item()
    assert err <= tol, err
