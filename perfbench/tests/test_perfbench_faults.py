"""A run of the harness with the timed path broken underneath comes out not
correct (its look for a card skipped; a tiny cell on the CPU)."""

from __future__ import annotations

import pytest
import torch

from perfbench import run as prun
from perfbench.tests.tiny import tiny_cell


def _broken_run(monkeypatch, fault):
    from guava_renderer_tpu_torch.cli import inference

    real = inference.FramePipeline.render_frame
    seen = []

    def render_frame(self, avatar, target):
        out = real(self, avatar, target)
        seen.append(out)
        return fault(out, seen)

    monkeypatch.setattr(inference.FramePipeline, "render_frame", render_frame)
    cell = tiny_cell(size=64, refiner=32)
    cell.workload["check"].update(frames=3, within=3)
    return prun.run_cell(cell.name, 2 ** 36 + 77, 2.5, False, torch.device("cpu"), cell)


def _altered(out, seen):
    render = out["render"].clone()
    render[10:20, 10:20] = 1.0 - render[10:20, 10:20]     # an answer altered where produced
    return dict(out, render=render)


def _stale(out, seen):
    return seen[0]                                        # the first frame, whatever the pose


def _no_raster(out, seen):
    return dict(out, raw=torch.zeros_like(out["raw"]))


def _nothing_compared(monkeypatch):
    from perfbench.drivers import motion

    monkeypatch.setattr(motion, "sample_frames", lambda seed, n, within: [10 ** 6])


@pytest.mark.parametrize("fault", [_altered, _stale, _no_raster])
def test_broken_frame_is_not_correct(monkeypatch, fault):
    run, out = _broken_run(monkeypatch, fault)
    assert run.attempted >= 3
    assert out["correct"] is False


def test_no_frame_compared_is_not_correct(monkeypatch):
    _nothing_compared(monkeypatch)
    run, out = _broken_run(monkeypatch, lambda out, seen: out)
    assert out["correct"] is False
