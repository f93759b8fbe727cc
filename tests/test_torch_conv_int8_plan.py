"""PyTorch port: the plans of the int8 conv kernels
(``ops/conv_int8.py``: ``plan_conv_int8``, ``plan_head_pair_int8``,
``plan_conv_int8_requant``), on the CPU. The kernels run only on the card
(``tests/test_torch_kernels_cuda.py``); what is planned on the host is
checked here: the tiles match the instantiations in the CUDA source, each
call of the serving paths at full width plans the tile, grid, shared
memory and channel padding counted by hand, and what the kernels do not
take raises."""

import math
import re
from pathlib import Path

import pytest
import torch

from _torch_int8_geoms import INT8_GEOMS, PAIR_GEOMS, REQUANT_GEOMS
from gan_sr_wind_field_tpu_torch.ops import conv_int8
from gan_sr_wind_field_tpu_torch.ops.conv_int8 import (
    HEAD_TILE,
    NARROW_TILE,
    REM_TILE,
    WIDE_TILE,
    ConvInt8Tile,
    pack_conv_int8,
    plan_conv_int8,
    plan_conv_int8_requant,
    plan_head_pair_int8,
)

SOURCE = (Path(conv_int8.__file__).parent / "kernels" / "csrc"
          / "conv_int8.cu")


def _tiles():
    """name -> ConvInt8Tile of each `using Name = Tile<BM, BN, WG, NSTAGE,
    DYS>;` in the CUDA source."""
    return {m[0]: ConvInt8Tile(*map(int, m[1:]))
            for m in re.findall(
                r"using (\w+) = Tile<(\d+), (\d+), (\d+), (\d+), (\d+)>;",
                SOURCE.read_text())}


def _smem(tile, Z, k, pad):
    """Shared memory counted by hand: the weight ring (min(dys, ky) kernel
    rows x kz taps x 64 channels x bn per slot), the windows (bm + 2 (py Z
    + pz) rows of 64 bytes; two where a window's ceil(ky / dys) stages
    cover the ring's lead of stages - 1, else one per slot), the zero
    row."""
    kx, ky, kz = k
    groups = -(-ky // tile.dys)
    windows = 2 if groups >= tile.stages - 1 else tile.stages
    return (tile.stages * min(tile.dys, ky) * kz * 64 * tile.bn
            + windows * (tile.bm + 2 * (pad[1] * Z + pad[2])) * 64 + 64)


def test_plan_tiles_are_the_sources_instantiations():
    assert _tiles() == {"HeadTile": HEAD_TILE, "RemTile": REM_TILE,
                        "WideTile": WIDE_TILE, "NarrowTile": NARROW_TILE}
    text = SOURCE.read_text()
    assert "constexpr int SLICE = 64;" in text
    # the int8 wgmma of every tile's width, A from registers
    for t in _tiles().values():
        assert (f"wgmma.mma_async.sync.aligned.m64n{t.bn}k32.s32.s8.s8"
                in text)
        # whole m64 tiles per warpgroup, at most 1024 threads
        assert t.bm % (64 * t.warpgroups) == 0 and t.threads <= 1024
    # the head pair shares one block shape
    assert (HEAD_TILE.bm, HEAD_TILE.threads) == (REM_TILE.bm,
                                                 REM_TILE.threads)
    # the remainder's 400 stacked columns are 5 chunks of 80
    assert 400 % REM_TILE.bn == 0


# the serving paths' calls at milestone9k, batch 8: the head's main conv
# and remainder at HR 64x64x10 (through head_pair_int8 in the serving path,
# through conv3d_int8 here), the trunk's growth convs and LFF at LR
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
    pads = (pad,) * 3 if isinstance(pad, int) else pad
    assert plan["tile"] == tile
    assert plan["grid"] == (-(-rows // tile.bm), -(-co // tile.bn))
    assert plan["cip"] == cip and plan["ci_x"] == ci
    assert plan["smem"] == _smem(tile, shape[3], k, pads)
    # the LFF at batch 8: 320 row blocks of one 128-column chunk, more
    # blocks than the card's 132 SMs; its slots hold one tap
    if k == (1, 1, 1):
        assert plan["grid"] == (320, 1)
        assert plan["smem"] == 3 * 64 * 128 + 3 * 64 * 64 + 64
    # a growth conv: 160 blocks of 128 rows, a stage of all 9 (dy, dz)
    # taps of a dx (18 KB a slot), a window per slot
    if k == (3, 3, 3):
        assert plan["grid"] == (160, 1)
        assert plan["smem"] == 3 * 9 * 64 * 32 + 3 * 150 * 64 + 64


@pytest.mark.parametrize("n", [8, 32])
def test_head_pair_plan_at_full_width(n):
    """The head pair at milestone9k: 5x5x5 128 -> 128 and 1x1x5 128 -> 400
    in one launch over 256-row blocks: one main column chunk of 128 and
    five of 80."""
    plan = plan_head_pair_int8((n, 64, 64, 10), 128, 128, 400, (5, 5, 5), 2)
    rows = n * 64 * 64 * 10
    assert plan["main"] == HEAD_TILE and plan["rem"] == REM_TILE
    assert plan["grid"] == (rows // 256, 1 + 5)
    assert plan["cip"] == 128 and plan["ci_x"] == 128
    main = _smem(HEAD_TILE, 10, (5, 5, 5), (2, 2, 2))
    rem = _smem(REM_TILE, 10, (1, 1, 5), (0, 0, 2))
    # 3 slots of 5 x 64 x 128 and two windows of 256 + 4 x 11 rows
    assert main == 3 * 40960 + 2 * 300 * 64 + 64 == 161344
    # the remainder: one stage per window, so a window per slot, 260 rows
    assert rem == 3 * 25600 + 3 * 260 * 64 + 64
    assert plan["smem"] == max(main, rem) == main
    alone = plan_head_pair_int8((n, 64, 64, 10), 128, 128, 0, (5, 5, 5), 2)
    assert alone["rem"] is None and alone["grid"] == (rows // 256, 1)
    assert alone["smem"] == main


def test_requant_plan_at_full_width():
    """The four growth convs of an RDB step at LR batch 8 into their
    buffer of 128 + 4 x 32 channels: 160 blocks of 128 rows x 32 columns."""
    for k in range(4):
        ci = 128 + 32 * k
        plan = plan_conv_int8_requant((8, 16, 16, 10), ci, 32, (3, 3, 3), 1,
                                      256, 256, ci)
        assert plan["tile"] == NARROW_TILE and plan["grid"] == (160, 1)
        assert plan["cip"] == ci
        assert plan["smem"] == 3 * 9 * 64 * 32 + 3 * 150 * 64 + 64


@pytest.mark.parametrize("geom", INT8_GEOMS)
def test_plan_at_the_card_tests_geometries(geom):
    N, X, Y, Z, ci, co, k, pad, _ = geom
    plan = plan_conv_int8((N, X, Y, Z), ci, co, k, pad)
    tile = WIDE_TILE if co > 32 else NARROW_TILE
    assert plan["tile"] == tile
    assert plan["grid"] == (math.ceil(N * X * Y * Z / tile.bm),
                            math.ceil(co / tile.bn))
    assert plan["smem"] == _smem(tile, Z, k, pad)
    assert plan["cip"] % 32 == 0 and 0 <= plan["cip"] - ci < 32
    assert plan["ci_x"] % 16 == 0 and 0 <= plan["ci_x"] - ci < 16


@pytest.mark.parametrize("geom", PAIR_GEOMS)
def test_head_pair_plan_at_the_card_tests_geometries(geom):
    N, X, Y, Z, ci, cm, cr, k = geom
    p = (k - 1) // 2
    plan = plan_head_pair_int8((N, X, Y, Z), ci, cm, cr, (k,) * 3, p)
    assert plan["grid"] == (math.ceil(N * X * Y * Z / 256),
                            math.ceil(cm / 128) + math.ceil(cr / 80))
    assert (plan["rem"] is None) == (cr == 0)
    smem = _smem(HEAD_TILE, Z, (k,) * 3, (p,) * 3)
    if cr:
        smem = max(smem, _smem(REM_TILE, Z, (1, 1, k), (0, 0, p)))
    assert plan["smem"] == smem
    assert plan["ci_x"] % 16 == 0 and 0 <= plan["ci_x"] - ci < 16


@pytest.mark.parametrize("geom", REQUANT_GEOMS)
def test_requant_plan_at_the_card_tests_geometries(geom):
    N, X, Y, Z, ci, co, ldx, ldo, col, _, k = geom
    p = (k - 1) // 2
    plan = plan_conv_int8_requant((N, X, Y, Z), ci, co, (k,) * 3, p, ldx,
                                  ldo, col)
    assert plan["tile"] == NARROW_TILE
    assert plan["grid"] == (math.ceil(N * X * Y * Z / 128),
                            math.ceil(co / 32))
    assert plan["smem"] == _smem(NARROW_TILE, Z, (k,) * 3, (p,) * 3)
    assert plan["cip"] % 32 == 0 and 0 <= plan["cip"] - ci < 32


@pytest.mark.parametrize("ci,ldx,ldo,col,match", [
    (20, 32, 64, 32, "multiples of 16"),    # ci not a multiple of 16
    (32, 40, 64, 40, "multiples of 16"),    # the input pitch
    (64, 48, 96, 64, "within the pitch"),   # ci past the input pitch
    (32, 64, 64, 40, "do not fit"),         # columns past the output pitch
    (32, 64, 64, -2, "do not fit"),         # a negative offset
])
def test_requant_plan_refuses_a_pitch_or_offset(ci, ldx, ldo, col, match):
    with pytest.raises(ValueError, match=match):
        plan_conv_int8_requant((1, 4, 4, 4), ci, 32, (3, 3, 3), 1, ldx, ldo,
                               col)


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
    # an extent past the instantiated taps per stage (kz of 1, 3 or 5)
    with pytest.raises(ValueError, match="up to 5"):
        plan_conv_int8((1, 9, 9, 9), 32, 32, (7, 7, 7), 3)
    # a head whose windows outgrow a block's shared memory (deep Z)
    with pytest.raises(ValueError, match="shared memory"):
        plan_head_pair_int8((1, 8, 8, 400), 128, 128, 400, (5, 5, 5), 2)


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
