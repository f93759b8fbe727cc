"""PyTorch port: the plan of the bf16 trunk kernels' tensor-core tiles
(``ops/rdb_trunk.py:plan_trunk_tc``), on the CPU. The tiles themselves
run only on the card (``tests/test_torch_kernels_cuda.py``); what is
planned on the host is checked here: the tiles match the instantiations
in the CUDA sources, every geometry the card tests use and milestone9k's
plan without raising and within a block's shared memory, the copy width
follows the alignment, and a volume too deep for the windows raises.
"""

import re
from pathlib import Path

import pytest

from _torch_trunk_geoms import TC_GEOMS
from gan_sr_wind_field_tpu_torch.ops import rdb_trunk
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    BWD_GROWTH_TILE,
    BWD_LFF_TILE,
    FWD_GROWTH_TILE,
    FWD_LFF_TILE,
    TC_SMEM_LIMIT,
    TcTile,
    plan_trunk_tc,
)

CSRC = Path(rdb_trunk.__file__).parent / "kernels" / "csrc"
MILESTONE9K = dict(nf=128, gc=32, num_convs=5)  # configs/milestone9k.ini


def _tiles(source):
    """name -> TcTile of each `using Name = tc::Tile<KS, BM, BN, WM, WN,
    NSTAGE[, RESIDENT]>;` in a CUDA source."""
    text = (CSRC / source).read_text()
    return {m[0]: TcTile(int(m[1]), int(m[2]), int(m[3]), int(m[6]),
                         m[7] == "true")
            for m in re.findall(r"using (\w+) = tc::Tile<(\d+), (\d+), "
                                r"(\d+), (\d+), (\d+), (\d+)"
                                r"(?:, (true|false))?>;", text)}


def test_plan_tiles_are_the_sources_instantiations():
    assert _tiles("rdb_trunk.cu") == {"GrowthTile": FWD_GROWTH_TILE,
                                      "LffTile": FWD_LFF_TILE}
    assert _tiles("rdb_trunk_bwd.cu") == {"GrowthTile": BWD_GROWTH_TILE,
                                          "LffTile": BWD_LFF_TILE}
    assert BWD_GROWTH_TILE.resident and not FWD_GROWTH_TILE.resident


@pytest.mark.parametrize("n", [8, 32])
def test_plan_at_milestone9k(n):
    """Served at batch 8 (20480 rows), trained at 32 (81920): 16-byte
    copies, one block per 256 rows of a growth conv, and the bytes of each
    tile counted by hand."""
    plan = plan_trunk_tc((n, 16, 16, 10), **MILESTONE9K)
    assert plan["vec"] == 8
    convs = plan["convs"]
    rows = n * 2560
    # zero row + 3 slots x (window of 256 + 22 rows x 64 B + 9 taps x 32
    # channels x 32 columns x 2 B)
    window, weights = (256 + 22) * 64, 9 * 32 * 32 * 2
    assert convs["fwd_growth"]["smem"] == 64 + 3 * (window + weights)
    assert convs["fwd_growth"]["grid"] == (rows // 256, 1)
    assert convs["fwd_lff"]["smem"] == 64 + 3 * (64 * 64 + 32 * 128 * 2)
    assert convs["fwd_lff"]["grid"] == (rows // 64, 1)
    # the transposed growth conv keeps the 3 windows of the one 32-channel
    # slice of d_u and streams weights only, all 224 columns per block
    assert convs["bwd_growth"]["smem"] == 64 + 3 * window + 3 * weights
    assert convs["bwd_growth"]["grid"] == (rows // 256, 1)
    # the LFF transpose keeps 4 slices of 128 rows, streams 4 x 32 x 64
    assert convs["bwd_lff"]["smem"] == 64 + 4 * 128 * 64 + 4 * 32 * 64 * 2
    assert convs["bwd_lff"]["grid"] == (rows // 128, 1)
    # two blocks of each growth tile fit on an SM
    assert all(2 * c["smem"] <= TC_SMEM_LIMIT for c in convs.values())


@pytest.mark.parametrize("nf,gc,num_convs,shape,vec", TC_GEOMS)
def test_plan_at_the_card_tests_geometries(nf, gc, num_convs, shape, vec):
    plan = plan_trunk_tc(shape, nf, gc, num_convs)
    assert plan["vec"] == vec
    rows = shape[0] * shape[1] * shape[2] * shape[3]
    for conv in plan["convs"].values():
        assert conv["smem"] <= TC_SMEM_LIMIT
        assert conv["grid"][0] * conv["tile"].bm >= rows


@pytest.mark.parametrize("offset_bytes,vec", [(0, 8), (16, 8), (8, 4),
                                              (4, 2), (2, 1)])
def test_plan_copy_width_follows_pointer_alignment(offset_bytes, vec):
    base = 1 << 20  # a 256-byte aligned allocation
    plan = plan_trunk_tc((2, 16, 16, 10), **MILESTONE9K,
                         pointers=[base, base + offset_bytes])
    assert plan["vec"] == vec


def test_plan_raises_for_a_volume_too_deep_for_the_windows():
    """The forward growth tile's three slots each hold a window of
    256 + 2(Zl + 1) rows of 64 B and 18432 B of weights: 227 KB is
    reached past Zl = 332."""
    plan_trunk_tc((1, 4, 4, 332), **MILESTONE9K)
    with pytest.raises(ValueError, match="shared memory"):
        plan_trunk_tc((1, 4, 4, 333), **MILESTONE9K)
