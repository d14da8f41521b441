"""The control of each cell's comparison: the reference put in the port's
place and computed in TF32, the nearest precision below the configuration's
float32, has to come out not correct, while the port comes out correct. On
the card, at the cell's own sizes, one seed and one frame."""

from __future__ import annotations

import pytest

from perfbench import harness


@pytest.mark.card
def test_control_fails_port_passes(card):
    cell = harness.find_cell("out2048.motion")
    cell.workload["check"]["frames"] = 1
    limits = cell.workload["check"]["limits"]
    seed = 2 ** 35 + 21
    rec = next(cell.driver().calibration(cell, [seed], {seed}, set(), card))
    assert all(rec["port"][k] <= limits[k] for k in limits), rec
    assert any(rec["control"][k] > limits[k] for k in limits), rec


def test_calibration_runs_on_the_cpu():
    import torch

    from perfbench.tests.tiny import tiny_cell

    cell = tiny_cell()
    recs = list(cell.driver().calibration(cell, [5, 6], {6}, set(), torch.device("cpu")))
    assert [r["seed"] for r in recs] == [5, 6] and recs[0]["control"] is None
    assert all(v < 1e-5 for r in recs for v in r["port"].values())


@pytest.mark.card
def test_train_control_and_half_batch_fail_port_passes(card):
    cell = harness.find_cell("ubody512.train")
    limits = cell.workload["check"]["limits"]
    seed = 2 ** 35 + 23
    rec = next(cell.driver().calibration(cell, [seed], {seed}, {seed}, card))
    assert all(rec["port"][k] <= limits[k] for k in limits), rec
    assert any(rec["control"][k] > limits[k] for k in limits), rec
    assert any(rec["half_batch"][k] > limits[k] for k in limits), rec
