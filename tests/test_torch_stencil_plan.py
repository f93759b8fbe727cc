"""PyTorch port: the plan of the stencil kernels' tiles
(``ops/stencil.py:plan_stencil``), on the CPU. The kernels themselves run
only on the card (``tests/test_torch_kernels_cuda.py``); what is planned on
the host is checked here: the tiles match the instantiations in the CUDA
source, the training batch of milestone9k, ragged tiles, one sample and the
smallest volume plan with the grid and shared memory counted by hand, and a
volume too deep for a block's shared memory, or too small, raises.
"""

import re
from pathlib import Path

import pytest

from _torch_stencil_geoms import STENCIL_GEOMS
from gan_sr_wind_field_tpu_torch.ops import stencil
from gan_sr_wind_field_tpu_torch.ops.kernels.tc_plan import TC_SMEM_LIMIT
from gan_sr_wind_field_tpu_torch.ops.stencil import (
    ADJ_TILE,
    GRAD_TILE,
    StencilTile,
    plan_stencil,
)

SOURCE = Path(stencil.__file__).parent / "kernels" / "csrc" / "stencil.cu"


def _pitch(n):
    """Floats of a staged row of n floats: room for any offset in a
    16-byte line, in whole 16-byte units."""
    return -(-(n + 3) // 4) * 4


def _smem(t, zl, cin, cout, zc):
    """Bytes by hand: a ring of ahead + 3 input rows with their y halo and
    as many rows of heights, two output rows, the x and y triples, and the
    z triples of two rows."""
    ring = t.ahead + 3
    return 4 * (ring * (_pitch((t.ty + 2) * zl * cin) + _pitch(t.ty * zl))
                + 2 * _pitch(t.ty * zl * cout) + 3 * (t.tx + t.ty)
                + (6 * t.ty * zl if zc else 0))


def _tiles():
    """name -> StencilTile of each `using Name = Tile<TX, TY, NT, AHEAD>;`
    in the CUDA source."""
    text = SOURCE.read_text()
    return {m[0]: StencilTile(*map(int, m[1:]))
            for m in re.findall(
                r"using (\w+) = Tile<(\d+), (\d+), (\d+), (\d+)>;", text)}


def test_plan_tiles_are_the_sources_instantiations():
    assert _tiles() == {"GradTile": GRAD_TILE, "AdjTile": ADJ_TILE}
    text = SOURCE.read_text()
    assert "static constexpr int RING = AHEAD + 3;" in text
    for t in (GRAD_TILE, ADJ_TILE):
        assert t.nt % 32 == 0 and t.nt <= 1024  # whole warps, one block
        assert t.ring == t.ahead + 3 and t.ahead >= 1


@pytest.mark.parametrize("adjoint", [False, True])
def test_plan_at_milestone9k(adjoint):
    """The training batch, 32 x 64 x 64 x 10: whole strips only, 512
    blocks of 8 x 32 columns for the forward and 256 of 16 x 32 for the
    adjoint, and the bytes counted by hand."""
    t = ADJ_TILE if adjoint else GRAD_TILE
    plan = plan_stencil((32, 64, 64, 10), adjoint)
    assert plan["tile"] == t
    assert 64 % t.tx == 0 and 64 % t.ty == 0
    assert plan["grid"] == 32 * (64 // t.tx) * (64 // t.ty)
    assert plan["grid"] == (256 if adjoint else 512)
    cin, cout = (9, 3) if adjoint else (3, 9)
    assert plan["smem"] == _smem(t, 10, cin, cout, adjoint) <= TC_SMEM_LIMIT
    assert plan["smem"] == (70176 if adjoint else 45120)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("shape", STENCIL_GEOMS)
def test_plan_at_the_card_tests_geometries(shape, adjoint):
    """Every geometry of the card tests plans, its tiles cover the volume
    with less than one tile to spare on each axis, and N rides the grid."""
    N, X, Y, Zl = shape
    t = ADJ_TILE if adjoint else GRAD_TILE
    plan = plan_stencil(shape, adjoint)
    tiles_x, tiles_y = -(-X // t.tx), -(-Y // t.ty)
    assert tiles_x * t.tx - X < t.tx and tiles_y * t.ty - Y < t.ty
    assert plan["grid"] == N * tiles_x * tiles_y
    assert plan["smem"] <= TC_SMEM_LIMIT


def test_geometries_hold_ragged_tiles_and_one_sample():
    """The shared geometries reach what the card tests are for: a partial
    strip in x and in y at once past the first, a Y of many tiles and a
    partial one, one sample, and the smallest volume."""
    for t in (GRAD_TILE, ADJ_TILE):
        assert any(X % t.tx and Y % t.ty and X > t.tx and Y > t.ty
                   for _, X, Y, _ in STENCIL_GEOMS)
        assert any(Y > 4 * t.ty and Y % t.ty for _, _, Y, _ in STENCIL_GEOMS)
    assert any(N == 1 for N, _, _, _ in STENCIL_GEOMS)
    assert (1, 2, 2, 2) in STENCIL_GEOMS


@pytest.mark.parametrize("adjoint", [False, True])
def test_plan_ragged_tiles(adjoint):
    """X = 21 and Y = 45 leave a partial strip on both axes: 2 or 3 in x,
    2 in y."""
    t = ADJ_TILE if adjoint else GRAD_TILE
    plan = plan_stencil((2, 21, 45, 7), adjoint)
    assert plan["grid"] == 2 * -(-21 // t.tx) * -(-45 // t.ty)
    assert plan["grid"] == (2 * 2 * 2 if adjoint else 2 * 3 * 2)


@pytest.mark.parametrize("adjoint", [False, True])
def test_plan_one_sample_and_two_points_per_axis(adjoint):
    plan = plan_stencil((1, 2, 2, 2), adjoint)
    assert plan["grid"] == 1
    for shape in ((1, 1, 2, 2), (1, 2, 1, 2), (1, 2, 2, 1)):
        with pytest.raises(ValueError, match="2 points per axis"):
            plan_stencil(shape, adjoint)


@pytest.mark.parametrize("adjoint,deepest", [(False, 52), (True, 33)])
def test_plan_raises_for_a_volume_too_deep_for_the_tile(adjoint, deepest):
    """Every staged row grows with Zl: a block's 227 KB is reached past
    Zl = 52 for the forward's tile and 33 for the adjoint's."""
    t = ADJ_TILE if adjoint else GRAD_TILE
    cin, cout = (9, 3) if adjoint else (3, 9)
    assert _smem(t, deepest, cin, cout, adjoint) <= TC_SMEM_LIMIT \
        < _smem(t, deepest + 1, cin, cout, adjoint)
    plan_stencil((1, 4, 4, deepest), adjoint)
    with pytest.raises(ValueError, match="shared memory"):
        plan_stencil((1, 4, 4, deepest + 1), adjoint)


def test_plan_raises_for_a_sample_past_32_bit_offsets():
    with pytest.raises(ValueError, match="32-bit"):
        plan_stencil((1, 2 ** 14, 2 ** 14, 2))
