"""Trunk geometries at the edges of the bf16 tensor-core tile
(``ops/kernels/csrc/trunk_mma.cuh``), shared by the CPU plan tests and the
card tests: (nf, gc, num_convs, (N, X, Y, Zl), channels per copy)."""

TC_GEOMS = [
    # 315 rows, no multiple of a block; cin 8..16, below one k16 step
    (8, 4, 3, (3, 5, 3, 7), 4),
    # 40 + 12 k channels: slices straddle the state/growth split, growth
    # slices start at 24-byte offsets
    (40, 12, 5, (3, 5, 3, 7), 4),
    # 4-byte copies; y and z smaller than a window's rows
    (10, 6, 3, (2, 3, 2, 3), 2),
    # odd channel counts: plain loads; y = 1
    (9, 3, 3, (1, 4, 1, 2), 1),
    # the served widths, one sample of two x-planes
    (128, 32, 5, (1, 2, 16, 10), 8),
    # the served widths at the held-out test volume (128x128x10 HR)
    (128, 32, 5, (1, 32, 32, 10), 8),
]
