"""CPU test of ``train.gather_grad_share`` on a synthetic device trace."""
from __future__ import annotations

import pytest

from benchmark import harness, yardstick


class _Ctx:
    counts, layer = {"steps": 2}, {}

    def __init__(self, trace):
        self.device_trace = trace


def test_gather_grad_share_counts_both_backwards_and_nothing_else():
    ops = [
        ("void (anonymous namespace)::indexing_backward_kernel_small_stride"
         "<float>(long const*, long const*, float const*, float*)", 0, 300),
        ("void (anonymous namespace)::indexing_backward_kernel_stride_1"
         "<float>(long const*, float const*, float*)", 300, 400),
        ("void (anonymous namespace)::gather_rows_grad_kernel<3>"
         "(int, int, int, long const*, float const*, float*, unsigned int*, "
         "float*)", 400, 450),
        ("void at::native::vectorized_elementwise_kernel<4, ...>", 450, 950),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 950, 1000),
    ]
    read = harness.reader("train.gather_grad_share")
    t = yardstick.DeviceTrace(ops, [], window_s=1000e-9)
    assert read(_Ctx(t)) == pytest.approx(450 / 1000)
    others = yardstick.DeviceTrace(ops[3:], [], window_s=1000e-9)
    assert read(_Ctx(others)) == 0.0


def test_gather_grad_share_is_none_without_a_trace():
    read = harness.reader("train.gather_grad_share")
    assert read(_Ctx(None)) is None
    assert read(_Ctx(yardstick.DeviceTrace([], [], window_s=1.0))) is None
