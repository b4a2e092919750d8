"""The trace reduction on a synthetic event list: busy time is the union
of the device intervals, idle gaps are named by the open span."""

import pytest
import torch

from benchmark import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, dev, start, dur, ann=False):
    return (name, dev, start, dur, ann)


def test_busy_groups_and_idle_by_span():
    events = [
        _ev("bench:tick_admit", CPU, 0.0, 4.0),
        _ev("bench:tick_decode", CPU, 5.0, 3.0),
        _ev("bench:tick_admit", CUDA, 0.0, 4.0, True),   # its device copy
        _ev("flash_fwd_wgmma", CUDA, 0.5, 1.0),
        _ev("decode_attend<PagedRows>", CUDA, 1.0, 1.0),  # overlaps
        _ev("nvjet_gemm", CUDA, 3.0, 0.5),
        _ev("elementwise", CUDA, 6.0, 1.0),
        _ev("aten::mm", CPU, 6.0, 0.1),
        _ev("outside", CUDA, 9.0, 1.0),                   # after the window
    ]
    s = trace.summarize_events(events)
    assert s["window_s"] == 8.0
    assert s["busy_s"] == pytest.approx(1.5 + 0.5 + 1.0)
    assert s["groups"]["flash_fwd"] == 1.0
    assert s["groups"]["paged_decode"] == 1.0
    assert s["groups"]["matmul"] == 0.5
    assert "outside" not in s["kernels"]
    # Gaps: 0-0.5 and 2-3 and 3.5-4 in the admit tick, 4-5 between ticks,
    # 5-6 and 7-8 in the decode tick.
    assert s["idle_by_span"]["tick_admit"] == pytest.approx(2.0)
    assert s["idle_by_span"]["harness"] == pytest.approx(1.0)
    assert s["idle_by_span"]["tick_decode"] == pytest.approx(2.0)


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize_events([_ev("bench:tick_decode", CPU, 0.0, 1.0)])
