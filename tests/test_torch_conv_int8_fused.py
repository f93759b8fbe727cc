"""PyTorch port: the fused int8 entry points' plain versions
(``ops/conv_int8.py``: ``head_pair_int8_reference``,
``conv3d_int8_requant_reference``) and the serving functions rebuilt on
them (``ops/quant.py:split_head_conv_int8``,
``ops/quant_trunk.py:trunk_int8_apply``), on the CPU, against the
compositions they replace, bit for bit (``torch.equal``): the int32 sums
are exact and every float operation is the same one in the same order.
The kernels run only on the card (``tests/test_torch_kernels_cuda.py``
holds them to these plain versions); the JAX package's int8 serving is
held to the port in ``tests/test_torch_quant.py``."""

import pytest
import torch
import torch.nn.functional as F

from _torch_int8_geoms import (
    PAIR_GEOMS,
    REQUANT_GEOMS,
    pair_inputs,
    requant_inputs,
)
from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu_torch.models.generator import (
    generator_from_config,
)
from gan_sr_wind_field_tpu_torch.ops import conv_int8
from gan_sr_wind_field_tpu_torch.ops import quant as pq
from gan_sr_wind_field_tpu_torch.ops import quant_trunk as pqt
from gan_sr_wind_field_tpu_torch.ops.conv_int8 import (
    conv3d_int8_reference,
    conv3d_int8_requant,
    conv3d_int8_requant_reference,
    head_pair_int8,
    head_pair_int8_reference,
)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", PAIR_GEOMS)
def test_head_pair_reference_equals_todays_composition(geom, out_dtype):
    """The pair's main columns are conv3d_int8_reference(...).to(dtype),
    its partials the remainder's conv3d_int8_reference at (0, 0, p); on
    the CPU the wrapper takes the plain version and launches nothing."""
    xq, wm, sm, wr, sr = pair_inputs(geom, sum(geom))
    k = geom[-1]
    p = (k - 1) // 2
    cm, cr = geom[5], geom[6]
    width = cm + (cr // (k * k) if cr else 0)
    out, partial = head_pair_int8_reference(xq, wm, sm, p, wr, sr,
                                            width=width, out_dtype=out_dtype)
    assert out.shape == (*xq.shape[:4], width) and out.dtype == out_dtype
    assert torch.equal(out[..., :cm],
                       conv3d_int8_reference(xq, wm, p, sm).to(out_dtype))
    if cr:
        assert torch.equal(partial,
                           conv3d_int8_reference(xq, wr, (0, 0, p), sr))
    else:
        assert partial is None
    before = conv_int8.pair_launches
    got, got_partial = head_pair_int8(xq, wm, sm, p, wr, sr, width=width,
                                      out_dtype=out_dtype)
    assert conv_int8.pair_launches == before
    assert torch.equal(got[..., :cm], out[..., :cm])
    assert (got_partial is None and partial is None) or torch.equal(
        got_partial, partial)


@pytest.mark.parametrize("geom", REQUANT_GEOMS)
def test_requant_reference_equals_todays_composition(geom):
    """out[..., col:col + co] = quantize_act(leaky_relu(conv3d_int8_reference
    of the first ci channels)), and nothing else of out changes."""
    N, X, Y, Z, ci, co, ldx, ldo, col, same, k = geom
    buf, wq, s, sc, out = requant_inputs(geom, sum(geom[:9]))
    p = (k - 1) // 2
    want_cols = pq.quantize_act(
        F.leaky_relu(conv3d_int8_reference(buf[..., :ci].clone(), wq, p, s),
                     0.2), sc)
    before_out = out.clone()
    got = conv3d_int8_requant_reference(buf, ci, wq, p, s, sc, 0.2, out, col)
    assert got is out
    assert torch.equal(got[..., col:col + co], want_cols)
    assert torch.equal(got[..., :col], before_out[..., :col])
    assert torch.equal(got[..., col + co:], before_out[..., col + co:])
    # the clamp and both LeakyReLU slopes are exercised
    assert (want_cols.abs() == 127).any() and (want_cols < 0).any()
    # the wrapper takes the plain version on the CPU and launches nothing
    again = before_out.clone()
    src = again if same else buf
    before = conv_int8.requant_launches
    conv3d_int8_requant(src, ci, wq, p, s, sc, 0.2, again, col)
    assert conv_int8.requant_launches == before
    assert torch.equal(again, got)


def _split_head_before(x, qh, padding, out_dtype):
    """``split_head_conv_int8`` as the port composed it before the pair:
    two convs, ``.to(out_dtype)`` and ``torch.cat``."""
    kx, ky, kz = qh.k
    xq = pq.quantize_act(x, qh.s_in)
    main = conv3d_int8_reference(xq, qh.wq_main, padding,
                                 qh.s_main).to(out_dtype)
    if qh.wq_rem is None:
        return main
    X, Y = x.shape[1], x.shape[2]
    cr = qh.cr
    partial = conv3d_int8_reference(xq, qh.wq_rem, (0, 0, padding),
                                    qh.s_rem)
    ppad = F.pad(partial, (0, 0, 0, 0, padding, padding, padding, padding))
    rem = torch.zeros(x.shape[:1] + (X, Y, partial.shape[3], cr),
                      dtype=torch.float32)
    for ix in range(kx):
        for iy in range(ky):
            t0 = (ix * ky + iy) * cr
            rem = rem + ppad[:, ix:ix + X, iy:iy + Y, :, t0:t0 + cr]
    return torch.cat([main, rem.to(out_dtype)], dim=-1)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout,k", [(128, 144, 5), (8, 12, 3)])
def test_split_head_conv_int8_is_todays_composition(cin, cout, k,
                                                    out_dtype):
    """The head rebuilt on head_pair_int8 (the shifted sum written into the
    pair's output) gives the served int8 head bit for bit: the split
    head at milestone9k's widths and an unsplit tiny one."""
    gen = torch.Generator().manual_seed(cin + k)
    x = torch.randn((1, 6, 5, 3, cin), generator=gen) * 1.5
    kernel = torch.randn((k, k, k, cin, cout), generator=gen) * 0.02
    qh = pq.quantize_split_head(kernel, pq.scales_from_amax(
        pq.head_input_amax(x)))
    assert (qh.wq_rem is None) == (cout < 128)
    got = pq.split_head_conv_int8(x, qh, k // 2, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (1, 6, 5, 3, cout)
    assert torch.equal(got, _split_head_before(x, qh, k // 2, out_dtype))


def _trunk_before(qt, x, out_dtype):
    """``trunk_int8_apply`` as the port composed it before the fused growth
    convs: float32 growth outputs, LeakyReLU, quantize_act and a
    ``torch.cat`` of the parts before every conv."""
    K = qt.num_convs - 1
    lp = (qt.lff_kern - 1) // 2
    cdt = out_dtype
    rrdb_scale = torch.tensor(qt.rrdb_scale, dtype=cdt)
    out = x.to(cdt)
    j = 0
    for _ in range(qt.num_rrdb):
        rr_in = out
        for _ in range(3):
            parts_q = [pq.quantize_act(out, qt.s_x[j])]
            for k in range(K):
                inq = parts_q[0] if k == 0 else torch.cat(parts_q, dim=-1)
                c = conv3d_int8_reference(inq, qt.wq[k][j], 1, qt.sw[k][j])
                c = F.leaky_relu(c, qt.negative_slope)
                parts_q.append(pq.quantize_act(c, qt.s_c[j, k]))
            inq = torch.cat(parts_q, dim=-1)
            res = conv3d_int8_reference(inq, qt.wq_lff[j], lp, qt.sw_lff[j],
                                        bias=qt.b_lff[j])
            out = (res * qt.rdb_scale).to(cdt) + out
            j += 1
        out = (out * rrdb_scale + rr_in).to(cdt)
    return out


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_trunk_int8_apply_is_todays_composition(out_dtype):
    """The int8 trunk rebuilt on one concat buffer per RDB step and the
    requantizing growth convs gives the served int8 trunk bit for bit
    (2 RRDBs, 5 convs per RDB, nf 16, gc 16)."""
    cfg = tiny_cfg(True, num_rdb_convs=5)
    G_cfg = cfg.generator
    G_cfg.num_RRDB = 2
    G_cfg.num_features = 16
    G_cfg.RDB_growth_chan = 16
    params = generator_from_config(cfg, device="cpu", seed=3).state_dict()
    geom = dict(num_rrdb=2, num_convs=5, lff_kern=1, rdb_scale=0.2,
                rrdb_scale=0.2, negative_slope=0.2)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 4, 5, 3, 16), generator=gen)
    _, ax, ac = pqt.trunk_reference_amax(params, x, **geom)
    qt = pqt.quantize_trunk(params, ax, ac, **geom)
    before = (conv_int8.launches, conv_int8.requant_launches)
    got = pqt.trunk_int8_apply(qt, x, out_dtype=out_dtype)
    assert (conv_int8.launches, conv_int8.requant_launches) == before
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got, _trunk_before(qt, x, out_dtype))
