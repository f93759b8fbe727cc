"""Volumes (N, X, Y, Zl) at the edges of the stencil kernels' strips
(``ops/kernels/csrc/stencil.cu``: 8 or 16 x rows of 32 columns), shared by
the CPU plan tests and the card tests."""

STENCIL_GEOMS = [
    # one partial tile: X and Y smaller than a tile, odd Zl
    (2, 5, 4, 3),
    # the training batch of milestone9k
    (32, 64, 64, 10),
    # X and Y short of one strip (7 and 19), odd Zl
    (3, 7, 19, 5),
    # partial strips in both x and y past the first (21 = 16 + 5 and
    # 8 + 8 + 5, 45 = 32 + 13)
    (2, 21, 45, 7),
    # wide Y: 130 = 4 x 32 + 2, a last tile of 2 columns
    (2, 96, 130, 10),
    # one sample, X one past a tile, Y one short of two
    (1, 5, 31, 10),
    # the minimum of 2 points per axis
    (1, 2, 2, 2),
    # the full HR volume of the 8x and 16x configurations at batch 8
    (8, 128, 128, 10),
]
