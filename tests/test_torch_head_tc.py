"""PyTorch port: the plan of the bf16 HR-head kernel's tensor-core tile
(``ops/hr_head.py:plan_head_tc``), on the CPU. The tile itself runs only
on the card (``tests/test_torch_kernels_cuda.py``); what is planned on the
host is checked here: the tiles match the instantiations in the CUDA
source, milestone9k's head at its served and trained batches, every
geometry the card tests use and k = 3 plan without raising and within a
block's shared memory, the copy width follows the alignment, and a volume
too deep for the windows, or a kernel size without a tile, raises.
"""

import re
from pathlib import Path

import pytest

from _torch_head_geoms import HEAD_GEOMS
from gan_sr_wind_field_tpu_torch.ops import hr_head
from gan_sr_wind_field_tpu_torch.ops.hr_head import (
    HEAD_TILES,
    HeadTile,
    plan_head_tc,
)
from gan_sr_wind_field_tpu_torch.ops.kernels.tc_plan import TC_SMEM_LIMIT

CSRC = Path(hr_head.__file__).parent / "kernels" / "csrc"
MILESTONE9K = dict(nf=128, tc=16, C=144)  # configs/milestone9k.ini


def _tiles(source):
    """name -> HeadTile of each `using Name = hd::Tile<KS>;` in a CUDA
    source."""
    text = (CSRC / source).read_text()
    return {m[0]: HeadTile(int(m[1]))
            for m in re.findall(r"using (\w+) = hd::Tile<(\d+)>;", text)}


def test_plan_tiles_are_the_sources_instantiations():
    assert _tiles("hr_head.cu") == {"HeadTile5": HEAD_TILES[5],
                                    "HeadTile3": HEAD_TILES[3]}
    # the shape hd::Tile fixes for both kernel sizes
    text = (CSRC / "head_mma.cuh").read_text()
    bm, bn = re.search(r"KS = KS_, BM = (\d+), BN = (\d+);", text).groups()
    warps, stages = re.search(r"WARPS = (\d+), NSTAGE = (\d+);",
                              text).groups()
    assert (HeadTile.bm, HeadTile.bn, HeadTile.warps, HeadTile.stages) == (
        int(bm), int(bn), int(warps), int(stages))
    for ks, tile in HEAD_TILES.items():
        assert tile.ks == ks
        # warpgroups of whole m64 tiles, and all of milestone9k's 144
        # columns in one block, so each block reads the head's weights once
        assert tile.warps % 4 == 0 and tile.bm % (16 * tile.warps) == 0
        assert tile.bn == MILESTONE9K["C"]


@pytest.mark.parametrize("n", [8, 32])
def test_plan_at_milestone9k(n):
    """Served at batch 8 (327,680 HR rows), trained at 32 (1,310,720):
    16-byte copies, one block per 256 rows and all 144 columns, and the
    bytes counted by hand."""
    plan = plan_head_tc((n, 64, 64, 10, 128), **MILESTONE9K, k=5)
    assert plan["vec"] == 8
    assert plan["grid"] == (n * 64 * 64 * 10 // 256, 1)
    # zero row + two windows of 256 + 4 (Zl + 1) rows x 64 B + 3 slots of
    # 5 taps x 32 channels x 144 columns x 2 B
    assert plan["smem"] == 64 + 2 * (256 + 44) * 64 + 3 * 5 * 32 * 144 * 2
    assert plan["smem"] == 176704 <= TC_SMEM_LIMIT


@pytest.mark.parametrize("n", [8, 32])
def test_plan_at_k3(n):
    """k = 3 (configs/tiny.ini) takes the same tile shape: windows of
    256 + 2 (Zl + 1) rows, slots of 3 taps."""
    plan = plan_head_tc((n, 64, 64, 10), **MILESTONE9K, k=3)
    assert plan["tile"] == HEAD_TILES[3]
    assert plan["smem"] == 64 + 2 * (256 + 22) * 64 + 3 * 3 * 32 * 144 * 2
    assert plan["grid"] == (n * 64 * 64 * 10 // 256, 1)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nf,tc,C,shape,vec", HEAD_GEOMS)
def test_plan_at_the_card_tests_geometries(nf, tc, C, shape, vec, k):
    plan = plan_head_tc(shape, nf, tc, C, k)
    assert plan["vec"] == vec
    rows = shape[0] * shape[1] * shape[2] * shape[3]
    assert plan["smem"] <= TC_SMEM_LIMIT
    assert plan["grid"][0] * plan["tile"].bm >= rows
    assert plan["grid"][1] * plan["tile"].bn >= C


@pytest.mark.parametrize("offset_bytes,vec", [(0, 8), (16, 8), (8, 4),
                                              (4, 2), (2, 1)])
def test_plan_copy_width_follows_pointer_alignment(offset_bytes, vec):
    base = 1 << 20  # a 256-byte aligned allocation
    plan = plan_head_tc((2, 64, 64, 10), **MILESTONE9K, k=5,
                        pointers=[base, base + offset_bytes])
    assert plan["vec"] == vec


@pytest.mark.parametrize("k,deepest", [(5, 118), (3, 454)])
def test_plan_raises_for_a_volume_too_deep_for_the_windows(k, deepest):
    """Two windows of 256 + 2 (k // 2)(Zl + 1) rows of 64 B and three
    weight slots: 227 KB is reached past Zl = 118 (k = 5) or 454 (k = 3)."""
    plan_head_tc((1, 4, 4, deepest), **MILESTONE9K, k=k)
    with pytest.raises(ValueError, match="shared memory"):
        plan_head_tc((1, 4, 4, deepest + 1), **MILESTONE9K, k=k)


@pytest.mark.parametrize("k", [1, 7])
def test_plan_raises_for_a_kernel_size_without_a_tile(k):
    with pytest.raises(ValueError, match="k = 3 or 5"):
        plan_head_tc((1, 4, 4, 4), **MILESTONE9K, k=k)
