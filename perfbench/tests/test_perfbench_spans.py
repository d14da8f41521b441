"""The span table: each device operation goes to the innermost `guava.*`
span open at its launch on the launching thread; an autograd node's
launches go to the span of the forward operation it differentiates; idle
gaps go to the span open at their middle; what no span owns is left
unattributed, and the table's seconds sum to the device's."""

from __future__ import annotations

import pytest

from perfbench import spans, tracing
from perfbench.spans import DeviceOp, HostEvent

MAIN, AUTOGRAD = 1, 2
NODE = spans.NODE


def host_events():
    """A step on thread 1: a loss span with a convolution (sequence number 7)
    and an inner LPIPS span, then guava.backward while autograd's thread 2
    runs the nodes."""
    return [
        HostEvent("guava.train_step", 0, 10_000, MAIN),
        HostEvent("guava.loss", 100, 1_000, MAIN),
        HostEvent("aten::conv2d", 200, 300, MAIN, seq=7),
        HostEvent("aten::convolution", 210, 290, MAIN, seq=7),
        HostEvent("guava.lpips", 500, 800, MAIN),
        HostEvent("aten::mul", 1_200, 1_300, MAIN, seq=8),        # outside every inner span
        HostEvent("guava.backward", 2_000, 9_000, MAIN),
        HostEvent(NODE + "ConvolutionBackward0", 3_000, 4_000, AUTOGRAD, seq=7, fwd_thread=MAIN),
        HostEvent(NODE + "MulBackward0", 4_100, 4_500, AUTOGRAD, seq=8, fwd_thread=MAIN),
        HostEvent(NODE + "torch::autograd::AccumulateGrad", 5_000, 5_500, AUTOGRAD),
        HostEvent(NODE + "_BlendBackward", 6_000, 7_000, AUTOGRAD, seq=9, fwd_thread=MAIN),
        HostEvent("guava.blend", 6_100, 6_900, AUTOGRAD),
    ]


def table_of(device, host=None):
    return spans.span_table(device, host_events() if host is None else host)


def test_innermost_span_owns_a_launch_and_its_parents_total_it():
    device = [DeviceOp("k_lpips", 600, 700, MAIN, 550),
              DeviceOp("k_loss", 900, 1_000, MAIN, 850)]
    t = table_of(device)
    assert t["guava.lpips"]["fwd_s"] == pytest.approx(100e-9)
    assert t["guava.loss"]["fwd_s"] == pytest.approx(100e-9)
    assert t["guava.loss"]["total_s"] == pytest.approx(200e-9)
    assert t["guava.train_step"]["total_s"] == pytest.approx(200e-9)
    assert t["guava.train_step"]["fwd_s"] == 0.0
    assert t["guava.loss"]["calls"] == 1
    assert t["guava.loss"]["host_s"] == pytest.approx(900e-9)


def test_autograd_launch_goes_to_its_forward_span_as_backward():
    # launched on autograd's thread inside ConvolutionBackward0 (sequence 7 of thread 1)
    t = table_of([DeviceOp("fft_bwd", 3_500, 3_900, AUTOGRAD, 3_200)])
    assert t["guava.loss"]["bwd_s"] == pytest.approx(400e-9)
    assert t["guava.loss"]["fwd_s"] == 0.0
    assert t["guava.backward"]["bwd_s"] == 0.0
    assert t["guava.train_step"]["total_s"] == pytest.approx(400e-9)


def test_node_of_an_op_outside_inner_spans_goes_to_the_enclosing_span():
    t = table_of([DeviceOp("mul_bwd", 4_200, 4_300, AUTOGRAD, 4_150)])
    assert t["guava.train_step"]["bwd_s"] == pytest.approx(100e-9)


def test_unlinked_node_is_left_to_guava_backward():
    t = table_of([DeviceOp("accumulate", 5_100, 5_200, AUTOGRAD, 5_050)])
    assert t["guava.backward"]["bwd_s"] == pytest.approx(100e-9)
    assert t["guava.train_step"]["total_s"] == pytest.approx(100e-9)


def test_span_opened_inside_a_node_owns_its_launches():
    t = table_of([DeviceOp("blend_bwd_kernel", 6_500, 6_800, AUTOGRAD, 6_200)])
    assert t["guava.blend"]["bwd_s"] == pytest.approx(300e-9)
    assert t["guava.blend"]["total_s"] == pytest.approx(300e-9)
    assert "guava.loss" not in t or t["guava.loss"]["bwd_s"] == 0.0


def test_idle_gap_goes_to_the_span_open_at_its_middle():
    # ops 0-100 and 1_100-1_200 on the device: the gap's middle 600 is in guava.lpips
    device = [DeviceOp("a", 0, 100, MAIN, 150), DeviceOp("b", 1_100, 1_200, MAIN, 900)]
    t = table_of(device)
    assert t["guava.lpips"]["idle_s"] == pytest.approx(1_000e-9)
    assert sum(r.get("idle_s", 0.0) for r in t.values()) == pytest.approx(1_000e-9)


def test_operation_outside_every_span_is_unattributed():
    device = [DeviceOp("copy_out", 11_000, 11_500, MAIN, 10_500),   # after the step
              DeviceOp("lost", 0, 50, None, None),                  # no launch found
              DeviceOp("k_loss", 900, 1_000, MAIN, 850)]
    t = table_of(device)
    assert t[spans.UNATTRIBUTED]["fwd_s"] == pytest.approx(550e-9)
    assert spans.device_seconds(t) == pytest.approx(650e-9)


def test_table_seconds_sum_to_the_trace_summary():
    device = [DeviceOp("k1", 600, 700, MAIN, 550), DeviceOp("k2", 3_500, 3_900, AUTOGRAD, 3_200),
              DeviceOp("k3", 5_100, 5_200, AUTOGRAD, 5_050),
              DeviceOp("k4", 11_000, 11_500, MAIN, 10_500)]
    summary = tracing.summarize_events([(d.name, d.start, d.end) for d in device], [], 1e-5)
    assert spans.device_seconds(table_of(device)) == pytest.approx(
        sum(s for s, _ in summary.by_name.values()))


def test_splitting_leaves_the_summary_and_the_readers_as_they_were():
    """On one CPU profile, the summary made while the table is split is the
    one `tracing.summarize` gives alone, field by field and through every
    metric reader, and the split is undone afterwards."""
    import torch

    from perfbench import harness

    with tracing.profiled(True) as prof:
        with torch.profiler.record_function("guava.outer"):
            torch.ones(256).sum()
    original = tracing.summarize
    alone = tracing.summarize(prof, 0.5)
    with spans.splitting() as got:
        split = tracing.summarize(prof, 0.5)
    assert tracing.summarize is original
    assert "guava.outer" in got["table"] and got["device_s"] == 0.0
    assert vars(split) == vars(alone)
    for name in ("out2048.motion", "ubody512.train"):
        cell = harness.find_cell(name)
        runs = []
        for summary in (alone, split):
            run = harness.Run(cell, 1, 1.0, True, torch.device("cpu"))
            run.summary, run.attempted, run.window_s = summary, 3, 0.5
            run.counts.update(frame_p95_ms=1.0, batch_wait_ms=2.0)
            runs.append(harness.per_layer_values(run))
        assert runs[0] == runs[1]


def test_events_of_a_cpu_profile_keeps_spans_and_autograd_links():
    import torch

    x = torch.ones(8, 8, requires_grad=True)
    with tracing.profiled(True) as prof:
        with torch.profiler.record_function("guava.fwd"):
            y = (x * 2).sum()
        with torch.profiler.record_function("guava.backward"):
            y.backward()
    device, host = spans.events_of(prof)
    assert device == []
    names = {h.name for h in host}
    assert {"guava.fwd", "guava.backward"} <= names
    assert any(h.name.startswith(NODE) and h.seq >= 0 for h in host)
    t = spans.span_table(device, host)
    assert t["guava.fwd"]["calls"] == 1 and t["guava.backward"]["calls"] == 1


def test_match_column_holds_each_owner_s_matching_seconds():
    import re

    device = [DeviceOp("fft2d_r2c", 3_500, 3_900, AUTOGRAD, 3_200),
              DeviceOp("k_loss", 900, 1_000, MAIN, 850),
              DeviceOp("fft2d_c2r", 11_000, 11_100, MAIN, 10_500)]
    t = spans.span_table(device, host_events(), re.compile("fft"))
    assert t["guava.loss"]["match_s"] == pytest.approx(400e-9)
    assert t["guava.loss"]["match_bwd_s"] == pytest.approx(400e-9)
    assert t[spans.UNATTRIBUTED]["match_s"] == pytest.approx(100e-9)
    assert t["guava.train_step"]["match_s"] == 0.0
