"""Calls of the int8 conv kernel (``ops/kernels/csrc/conv_int8.cu``) at the
edges of its tiles (128 rows x 128 or 32 columns, 32-channel stages),
shared by the CPU plan tests and the card tests:
(N, X, Y, Z, ci, co, kernel extent, padding, with a bias)."""

INT8_GEOMS = [
    # ci 20: neither a multiple of 32 nor of 16 (x is padded to 32); co 1;
    # odd X and Z
    (2, 5, 4, 3, 20, 1, (3, 3, 3), (1, 1, 1), False),
    # ci 48 (16 but not 32); the narrow tile full at co 32, with a bias
    (1, 7, 3, 5, 48, 32, (3, 3, 3), (1, 1, 1), True),
    # the head's remainder: 1x1x5 to 400 columns (3 x 128 + 16)
    (2, 3, 5, 7, 128, 400, (1, 1, 5), (0, 0, 2), False),
    # the head's main conv, 5x5x5, at odd extents and with a bias
    (1, 9, 11, 3, 64, 128, (5, 5, 5), (2, 2, 2), True),
    # the LFF: 1x1x1, 256 -> 128, with its bias
    (3, 4, 4, 5, 256, 128, (1, 1, 1), (0, 0, 0), True),
    # Z of 1; co 33, one column past the narrow tile
    (1, 2, 3, 1, 32, 33, (1, 1, 1), (0, 0, 0), False),
    # the last growth conv at the trunk's LR extent, 224 -> 32
    (1, 16, 16, 10, 224, 32, (3, 3, 3), (1, 1, 1), False),
]
