"""The seeded arrival schedule and served fields."""

import numpy as np

from windbench import payloads


def test_every_seed_enters_one_poisson_trace_at_its_own_gap():
    a = payloads.arrivals(3, 24.0, 300.0, 1)
    b = payloads.arrivals(2**31 + 5, 24.0, 300.0, 1)
    assert np.array_equal(a, payloads.arrivals(3, 24.0, 300.0, 1))
    assert not np.array_equal(a, b)
    # rate x window requests, in order, inside the window, the first at 0
    assert len(a) == len(b) == 7200
    assert (np.diff(a) > 0).all() and a[0] == 0 and a[-1] < 300.0
    # the same trace: all gaps but the one where a seed wraps round agree
    ga, gb = np.diff(a), np.diff(b)
    assert len(np.intersect1d(ga.round(9), gb.round(9))) >= len(ga) - 1
    # exponential gaps; the count in each second varies as a Poisson
    # count's (variance ~ mean), it is not fixed per block of arrivals
    assert 0.95 < ga.std() / ga.mean() < 1.05
    per_s = np.bincount(a.astype(int), minlength=300)
    assert 0.8 < per_s.var() / per_s.mean() < 1.2
    # another trace seed is another trace
    c = payloads.arrivals(3, 24.0, 300.0, 2)
    assert len(np.intersect1d(np.diff(c).round(9), ga.round(9))) < 10


def test_fields_come_from_the_seed():
    lr, z = payloads.pool(11, 3, 32, 32, 10, 4)
    assert lr.shape == (3, 8, 8, 10, 4) and z.shape == (3, 32, 32, 10, 1)
    lr2, _ = payloads.pool(11, 3, 32, 32, 10, 4)
    lr3, _ = payloads.pool(12, 3, 32, 32, 10, 4)
    assert np.array_equal(lr, lr2) and not np.array_equal(lr, lr3)
    assert np.isfinite(lr).all() and np.abs(lr[..., :3]).max() < 1.0
