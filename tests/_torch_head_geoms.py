"""HR-head geometries at the edges of the bf16 tensor-core tile
(``ops/kernels/csrc/head_mma.cuh``), shared by the CPU plan tests and the
card tests: (nf, tc, C, (N, X, Y, Zl), channels per copy)."""

HEAD_GEOMS = [
    # nf + tc = 40 and C = 24 straddle the 32-wide channel slices and
    # the 144-wide column tile
    (24, 16, 24, (2, 6, 5, 4), 8),
    # milestone9k's widths, 128 + 16 -> 144
    (128, 16, 144, (2, 16, 16, 10), 8),
    # 945 rows, no multiple of a block, odd Y and Zl; samples of 315 rows,
    # so row tiles cross samples (and their dropout scales)
    (128, 16, 144, (3, 5, 7, 9), 8),
    # nf = 40: the second slice holds x's last 8 channels and t's 16
    (40, 16, 144, (2, 4, 6, 5), 8),
    # C = 24 of a 144-column tile, odd Y and Zl
    (40, 8, 24, (1, 9, 3, 11), 8),
    # 4-byte copies (nf 10, tc 6, C 22) and C not a multiple of 8
    (10, 6, 22, (2, 3, 4, 5), 2),
]
