"""The benchmark's counts against the figures the port's smoke run
derived for the same shapes."""

import pytest

from windbench import counts
from windbench.inputs import load_json, spec


@pytest.fixture(scope="module")
def g():
    return spec(load_json("configs", "milestone9k")).geometry


def test_trunk_flops_at_serving_batch_8(g):
    rows = 8 * 16 * 16 * 10
    assert 2 * counts.trunk_macs(rows, g) == pytest.approx(1.2603e12,
                                                           rel=1e-4)


def test_stencil_bytes_at_training_batch_32():
    assert counts.stencil_bytes(32 * 64 * 64 * 10) == pytest.approx(
        68.2e6, rel=1e-3)


def test_head_flops_at_batch_32(g):
    layers = {n: (v, k, ci, co) for n, v, k, ci, co, _ in
              counts.g_layers(g, (32, 16, 16, 10))}
    head = sum(2 * v * k * ci * co for n, (v, k, ci, co) in layers.items()
               if n.startswith("hr_conv0"))
    assert head == pytest.approx(6.795e12, rel=1e-3)


def test_backward_counts_weights_and_needed_data_gradients(g):
    lr = (2, 16, 16, 10)
    fwd = counts.g_forward_flops(g, lr)
    bwd = counts.g_backward_flops(g, lr)
    # the LR input and the heights need no gradient: a little under 2x
    assert fwd < bwd < 2 * fwd
    hr = (2, 64, 64, 10)
    assert counts.g_step_flops(g, lr, hr, True) > fwd + bwd
    assert counts.d_step_flops(g, lr, hr) > fwd


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0, counts.H100_BF16_FLOPS) == 1.0
    assert counts.least_seconds(0, 3.35e12, counts.H100_BF16_FLOPS) == 1.0
