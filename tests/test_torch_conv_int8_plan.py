"""PyTorch port: the plan of the int8 conv kernel
(``ops/conv_int8.py:plan_conv_int8``), on the CPU. The kernel runs only on
the card (``tests/test_torch_kernels_cuda.py``); what is planned on the
host is checked here: the tiles match the instantiations in the CUDA
source, each call of the serving paths at full width plans the tile, grid
and channel padding counted by hand, and what the kernel does not take
raises."""

import math
import re
from pathlib import Path

import pytest
import torch

from _torch_int8_geoms import INT8_GEOMS
from gan_sr_wind_field_tpu_torch.ops import conv_int8
from gan_sr_wind_field_tpu_torch.ops.conv_int8 import (
    NARROW_TILE,
    WIDE_TILE,
    ConvInt8Tile,
    pack_conv_int8,
    plan_conv_int8,
)

SOURCE = (Path(conv_int8.__file__).parent / "kernels" / "csrc"
          / "conv_int8.cu")


def _tiles():
    """name -> ConvInt8Tile of each `using Name = Tile<BM, BN, WARPS_M,
    WARPS_N, NSTAGE>;` in the CUDA source."""
    return {m[0]: ConvInt8Tile(*map(int, m[1:]))
            for m in re.findall(
                r"using (\w+) = Tile<(\d+), (\d+), (\d+), (\d+), (\d+)>;",
                SOURCE.read_text())}


def test_plan_tiles_are_the_sources_instantiations():
    assert _tiles() == {"WideTile": WIDE_TILE, "NarrowTile": NARROW_TILE}
    text = SOURCE.read_text()
    assert "constexpr int ROW = 48;" in text and "constexpr int SK = 32;" in text
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    for t in (WIDE_TILE, NARROW_TILE):
        # whole m16 x n16 warp tiles, one stage per 32 channels
        assert (t.bm // t.warps_m) % 16 == 0 and (t.bn // t.warps_n) % 16 == 0
        assert t.threads <= 1024
        # a static launch: no more than 48 KB of shared memory
        assert t.smem_bytes == t.stages * (t.bm + t.bn) * 48 <= 48 * 1024


# the serving paths' calls at milestone9k, batch 8: the head's main conv
# and remainder at HR 64x64x10, the trunk's growth convs and LFF at LR
# 16x16x10 -> (shape, ci, co, k, pad, tile, cip)
FULL_WIDTH = [
    ((8, 64, 64, 10), 128, 128, (5, 5, 5), 2, WIDE_TILE, 128),
    ((8, 64, 64, 10), 128, 400, (1, 1, 5), (0, 0, 2), WIDE_TILE, 128),
    ((8, 16, 16, 10), 128, 32, (3, 3, 3), 1, NARROW_TILE, 128),
    ((8, 16, 16, 10), 224, 32, (3, 3, 3), 1, NARROW_TILE, 224),
    ((8, 16, 16, 10), 256, 128, (1, 1, 1), 0, WIDE_TILE, 256),
]


@pytest.mark.parametrize("shape,ci,co,k,pad,tile,cip", FULL_WIDTH)
def test_plan_at_full_width(shape, ci, co, k, pad, tile, cip):
    plan = plan_conv_int8(shape, ci, co, k, pad)
    rows = math.prod(shape)
    assert plan["tile"] == tile
    assert plan["grid"] == (-(-rows // 128), -(-co // tile.bn))
    assert plan["cip"] == cip and plan["ci_x"] == ci
    assert plan["smem"] == tile.smem_bytes
    # the head's main conv at batch 8: 2560 row blocks of one 128 column
    if co == 128 and k == (5, 5, 5):
        assert plan["grid"] == (2560, 1)


@pytest.mark.parametrize("geom", INT8_GEOMS)
def test_plan_at_the_card_tests_geometries(geom):
    N, X, Y, Z, ci, co, k, pad, _ = geom
    plan = plan_conv_int8((N, X, Y, Z), ci, co, k, pad)
    tile = WIDE_TILE if co > 32 else NARROW_TILE
    assert plan["tile"] == tile
    assert plan["grid"] == (math.ceil(N * X * Y * Z / 128),
                            math.ceil(co / tile.bn))
    assert plan["cip"] % 32 == 0 and 0 <= plan["cip"] - ci < 32
    assert plan["ci_x"] % 16 == 0 and 0 <= plan["ci_x"] - ci < 16


@pytest.mark.parametrize("k,pad", [((3, 3, 3), 0), ((5, 5, 5), 1),
                                   ((1, 1, 5), 2), ((2, 2, 2), (1, 1, 1))])
def test_plan_refuses_a_padding_that_changes_the_extent(k, pad):
    with pytest.raises(ValueError, match="keeps the extent"):
        plan_conv_int8((1, 4, 4, 4), 32, 32, k, pad)


def test_plan_refuses_empty_and_too_large_calls():
    with pytest.raises(ValueError, match="empty"):
        plan_conv_int8((0, 4, 4, 4), 32, 32, (1, 1, 1), 0)
    with pytest.raises(ValueError, match="32-bit"):
        plan_conv_int8((64, 256, 256, 64), 128, 128, (1, 1, 1), 0)


def test_packed_weights_layout():
    """pack_conv_int8: (kx, ky, kz, co, cip), each output channel's input
    channels contiguous and zero-padded to 32."""
    gen = torch.Generator().manual_seed(0)
    wq = torch.randint(-127, 128, (3, 1, 5, 20, 7), generator=gen,
                       dtype=torch.int8)
    packed = pack_conv_int8(wq)
    assert packed.shape == (3, 1, 5, 7, 32) and packed.is_contiguous()
    assert torch.equal(packed[..., :20], wq.permute(0, 1, 2, 4, 3))
    assert not packed[..., 20:].any()
    with pytest.raises(ValueError, match="int8"):
        pack_conv_int8(wq.float())
