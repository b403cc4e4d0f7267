"""The trace reader: busy time is the union of device intervals, idle gaps
are named by the innermost host operation open at their middle."""

from __future__ import annotations

import pytest
import torch

from perfbench.tracing import CALL_LABEL, WINDOW_LABEL, Trace


def _trace():
    # window 0..100 ns; kernels overlap at 10..30 and 20..40, copy 60..70
    return Trace(window=(0, 100),
                 device=[(10, 30, "kernel", "gemm"), (20, 40, "kernel", "gemm"),
                         (60, 70, "gpu_memcpy", "Memcpy HtoD")],
                 host={1: [(0, 100, WINDOW_LABEL), (0, 100, CALL_LABEL),
                           (40, 60, "aten::item"), (45, 50, "cudaStreamSynchronize")],
                       2: [(80, 95, "aten::copy_")]})


def test_busy_is_the_union_not_the_sum():
    tr = _trace()
    assert tr.busy_intervals() == [(10, 40), (60, 70)]
    assert tr.busy_s == pytest.approx(40e-9) and tr.window_s == pytest.approx(100e-9)
    assert tr.kernels() == (2, pytest.approx(40e-9))
    assert tr.kernels("gemm")[0] == 2 and tr.kernels("adam") == (0, 0.0)
    assert tr.top_device_ops()[0] == ["gemm", pytest.approx(40e-9)]


def test_idle_gaps_by_innermost_host_operation():
    gaps = dict((n, s) for n, s in _trace().idle_gaps())
    # 0..10 and 40..60 (middle 50: aten::item, the sync having ended), 70..100
    # (middle 85: aten::copy_ on the second thread, started last)
    assert gaps == pytest.approx({CALL_LABEL: 10e-9, "aten::item": 20e-9,
                                  "aten::copy_": 30e-9})


def test_a_cpu_profile_reads_the_window_label():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            with torch.profiler.record_function(CALL_LABEL):
                torch.randn(64, 64) @ torch.randn(64, 64)
    tr = Trace.from_profile(prof)
    assert tr.window_s > 0 and tr.busy_s == 0
    assert any(n == CALL_LABEL for ops in tr.host.values() for _, _, n in ops)
