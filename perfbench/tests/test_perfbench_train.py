"""The training cell at micro widths on the CPU: the port against the frozen
reference through a run of the harness (its look for a card skipped), and
the runs that have to come out not correct, with the timed path broken
underneath: a step that leaves its state unchanged, half of each batch left
out with the mean taken over the rest, a loss altered where it is produced."""

from __future__ import annotations

import pytest
import torch

from perfbench import run as prun
from perfbench.tests.tiny import tiny_train_cell

SEED = 2 ** 37 + 11


def _run(seconds=0.5):
    cell = tiny_train_cell()
    return prun.run_cell(cell.name, SEED, seconds, False, torch.device("cpu"), cell)


def test_step_equals_port_through_a_run():
    run, out = _run()
    assert out["correct"] and run.attempted >= 1
    assert set(out["checks"]) == {"loss_rel", "grad_leaf_gap", "change_median_gap"}
    assert out["checks"]["loss_rel"]["value"] < 1e-7
    assert out["checks"]["grad_leaf_gap"]["value"] < 1e-3
    assert out["checks"]["change_median_gap"]["value"] < 1e-5
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert run.counts["pairs_per_step"] > 0 and run.counts["batch_wait_ms"] >= 0


def _unchanged(monkeypatch):
    from guava_renderer_tpu_torch.train import trainstep

    monkeypatch.setattr(trainstep, "_update", lambda state, count: torch.zeros(()))


def _half_batch(monkeypatch):
    from guava_renderer_tpu_torch.train import pipeline, trainstep

    real = pipeline.make_loss_fn

    def make_loss_fn(statics, lpips, remat=False):
        fn = real(statics, lpips, remat)
        return lambda batch, it: fn(trainstep.split_batch(batch, 0), it)

    from perfbench.drivers import train
    monkeypatch.setattr(pipeline, "make_loss_fn", make_loss_fn)
    assert train


def _altered_loss(monkeypatch):
    from guava_renderer_tpu_torch.train import trainstep

    real = trainstep._accumulate

    def accumulate(loss_fn, state, batches):
        loss, metrics = real(loss_fn, state, batches)
        return loss * 1.01, metrics

    monkeypatch.setattr(trainstep, "_accumulate", accumulate)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_broken_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    run, out = _run()
    assert out["correct"] is False, out["checks"]
