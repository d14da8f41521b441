"""The trace's busy time is the union of device intervals; idle gaps are
named by the innermost host operation running in them."""

from __future__ import annotations

import pytest

from perfbench import tracing


def test_union_gaps_and_names():
    device = [("k1", 0, 100), ("k2", 50, 150),         # overlap on two streams: 0-150
              ("copy", 400, 500), ("k1", 700, 900)]
    host = [("aten::outer", 100, 800), ("aten::inner", 200, 300), ("aten::late", 600, 650)]
    s = tracing.summarize_events(device, host, window_s=1e-6)
    assert s.busy_s == pytest.approx(450e-9)
    assert s.n_ops == 4
    assert s.by_name["k1"] == [pytest.approx(300e-9), 2]
    # gap 150-400 (middle 275: inside aten::inner), gap 500-700 (middle 600: aten::late)
    assert dict((k, v) for k, v in s.idle_gaps) == {"aten::inner": pytest.approx(250e-9),
                                                     "aten::late": pytest.approx(200e-9)}
    assert s.device_ops(1) == [["k1", pytest.approx(300e-9)]]


def test_no_host_operation_and_no_device():
    s = tracing.summarize_events([("k", 0, 10), ("k", 30, 40)], [], window_s=1.0)
    assert s.idle_gaps == [["(host between operations)", pytest.approx(20e-9)]]
    assert tracing.summarize_events([], [], 1.0).busy_s == 0.0


def test_profiled_off_yields_nothing():
    with tracing.profiled(False) as prof:
        assert prof is None


def test_annotations_are_not_device_operations():
    """A profile on the CPU: record_function's annotation is a host event;
    the summary's device list would drop a device event of its name."""
    import torch

    with tracing.profiled(True) as prof:
        with torch.profiler.record_function("perfbench_annotation"):
            torch.ones(64).sum()
    device, host = tracing._events(prof)
    assert "perfbench_annotation" in {n for n, _, _ in host}
    assert device == []
