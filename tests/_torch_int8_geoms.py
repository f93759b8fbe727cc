"""Calls of the int8 conv kernels (``ops/kernels/csrc/conv_int8.cu``) at the
edges of their tiles, shared by the CPU tests and the card tests.

``INT8_GEOMS``, ``conv3d_int8`` (64 rows x 128 or 32 columns, 64-channel
slices): (N, X, Y, Z, ci, co, kernel extent, padding, with a bias).

``PAIR_GEOMS``, ``head_pair_int8`` (256 rows; the main conv in chunks of
128 columns, the 1x1xk remainder in chunks of 80): (N, X, Y, Z, ci, cm,
cr, k) with the head's kernel k^3, padding (k - 1) / 2 and a remainder of
cr stacked channels (0: none).

``REQUANT_GEOMS``, ``conv3d_int8_requant`` (64 rows x 32 columns): (N, X,
Y, Z, ci, co, input pitch, output pitch, column offset, into the input's
own buffer, k) with padding (k - 1) / 2.

``pair_inputs`` and ``requant_inputs`` make a call's seeded inputs on the
CPU."""

import torch

from gan_sr_wind_field_tpu_torch.ops.conv_int8 import conv3d_int8_reference

INT8_GEOMS = [
    # ci 20: neither a multiple of 32 nor of 16 (x is padded to 32); co 1;
    # odd X and Z
    (2, 5, 4, 3, 20, 1, (3, 3, 3), (1, 1, 1), False),
    # ci 48 (16 but not 32: a half slice); the narrow tile full at co 32,
    # with a bias
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
    # mixed extents 3x1x5 (one window stage per dx: three window buffers)
    (1, 5, 6, 7, 96, 72, (3, 1, 5), (1, 0, 2), True),
]

PAIR_GEOMS = [
    # the head's widths (128 -> 128 + 25 x 16) at Z = 10: 630 rows, three
    # row blocks, the last partial
    (1, 7, 9, 10, 128, 128, 400, 5),
    # the same at an odd small volume: one partial row block
    (2, 3, 5, 7, 128, 128, 400, 5),
    # 3x3x3 with two main chunks (256) and a remainder of 9 x 16 = 144
    # columns (80 + 64); ci 48, a half slice
    (1, 8, 8, 5, 48, 256, 144, 3),
    # a head too narrow to split (no remainder), ci 20 (x padded to 32)
    (2, 3, 5, 4, 20, 12, 0, 3),
]

REQUANT_GEOMS = [
    # the last growth conv at the trunk's LR extent: 224 -> 32 into
    # columns 224..255 of the RDB step's buffer
    (1, 16, 16, 10, 224, 32, 256, 256, 224, True, 3),
    # the first growth conv, 128 -> 32 into columns 128..159
    (2, 5, 4, 3, 128, 32, 256, 256, 128, True, 3),
    # ci 48 (a half slice) of a 96-channel pitch, written at offset 48
    (1, 7, 3, 5, 48, 32, 96, 96, 48, True, 3),
    # another buffer of pitch 80 at offset 38; co 40, two column chunks
    (1, 4, 6, 3, 32, 40, 64, 80, 38, False, 3),
    # an odd offset and co (single-byte stores), 1x1x1, pitch wider than ci
    (2, 3, 3, 7, 16, 33, 32, 48, 15, False, 1),
    # Z of 1 and the tiny configs' growth of 4 channels
    (1, 2, 3, 1, 64, 4, 80, 80, 64, True, 3),
]


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


def pair_inputs(geom, seed):
    """Seeded int8 input and weights of a ``PAIR_GEOMS`` call and positive
    float32 scales of a served model's size."""
    N, X, Y, Z, ci, cm, cr, k = geom
    gen = torch.Generator().manual_seed(seed)
    xq = _int8(gen, N, X, Y, Z, ci)
    wm = _int8(gen, k, k, k, ci, cm)
    sm = torch.rand(cm, generator=gen) * 1e-4 + 1e-6
    wr = _int8(gen, 1, 1, k, ci, cr) if cr else None
    sr = torch.rand(cr, generator=gen) * 1e-4 + 1e-6 if cr else None
    return xq, wm, sm, wr, sr


def requant_inputs(geom, seed):
    """Seeded int8 buffer, weights, dequantizing and output scales of a
    ``REQUANT_GEOMS`` call (each channel's output scale between 1/508 and
    1/169 of its dequantized abs-max, so its largest values pass the int8
    range and the clamp is exercised), and the output buffer."""
    N, X, Y, Z, ci, co, ldx, ldo, col, same, k = geom
    gen = torch.Generator().manual_seed(seed)
    buf = _int8(gen, N, X, Y, Z, ldx)
    wq = _int8(gen, k, k, k, ci, co)
    s = torch.rand(co, generator=gen) * 1e-4 + 1e-6
    amax = conv3d_int8_reference(buf[..., :ci], wq, (k - 1) // 2,
                                 s).abs().amax(dim=(0, 1, 2, 3))
    sc = amax * (torch.rand(co, generator=gen) + 0.5) / 254.0
    out = buf if same else _int8(gen, N, X, Y, Z, ldo)
    return buf, wq, s, sc, out
