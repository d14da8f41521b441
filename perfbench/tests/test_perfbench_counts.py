"""The work counts against hand counts at tiny sizes."""

from __future__ import annotations

import pytest
import torch

from perfbench import counts
from perfbench.reference import raster


def test_least_time_takes_the_larger_bound():
    assert counts.least_time(67e12, 0.0) == (1.0, "ops")
    t, kind = counts.least_time(1.0, 3.35e12 * 2)
    assert kind == "bytes" and t == pytest.approx(2.0)


def test_blend_fwd_by_hand():
    # 10 pairs; 3 Gaussians of 176 B, 5 instance ids, 4 tiles + 1 ranges,
    # a 32 x 32 image of 34 floats (32 colours, inverse depth, T)
    ops, b = counts.blend_fwd(10, 3, 5, 32, 32, 16)
    assert counts.BLEND_FWD_OPS_PER_PAIR == 82
    assert ops == 820
    assert b == 3 * 176 + 5 * 4 + 5 * 4 + 32 * 32 * 34 * 4


def test_bilinear_taps_by_hand():
    # 8 -> 2 (factor 4): 8 taps, rows 2x8 then 2x2 outputs, 1 channel
    assert counts.bilinear_taps_flops(1, 8, 2) == 2 * 8 * (2 * 8 + 2 * 2)
    # 2 -> 8: 2 taps
    assert counts.bilinear_taps_flops(3, 2, 8) == 2 * 2 * 3 * (8 * 2 + 8 * 8)


def test_module_flops_by_hand():
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    lin = torch.nn.Linear(5, 7)
    assert counts.module_flops(conv, (1, 4, 6, 6)) == 2 * 8 * 6 * 6 * 4 * 9
    assert counts.module_flops(lin, (3, 5)) == 2 * 3 * 5 * 7


def test_contributing_pairs_by_hand():
    # one tile of 16 x 16 pixels, two Gaussians at the same pixel: the front
    # one at opacity 0.99 takes T to 0.01, the back one at 0.99 would take it
    # under 1e-4 and is not taken; a third, far away, contributes nowhere
    mean2d = torch.tensor([[3.0, 4.0], [3.0, 4.0], [100.0, 100.0]])
    conic = torch.tensor([[1e4, 0.0, 1e4]] * 3)      # a point: only pixel (3, 4) reaches 1/255
    alpha = torch.tensor([0.99, 0.99, 0.99])
    feats = torch.cat([torch.eye(3, 33), torch.ones(3, 1)], dim=1)    # last: 1 - T
    counts_ = torch.tensor([3])
    for grad in (False, True):
        acc, pairs = raster.blend_tiles(mean2d, conic, alpha, feats, torch.tensor([0]), counts_,
                                        torch.tensor([0, 1, 2]), 16, 16, 16, chunk=2, grad=grad)
        assert pairs == 1
        assert acc[4, 3, 0] == pytest.approx(0.99) and acc[4, 3, 1] == 0.0
        assert acc[4, 3, 33] == pytest.approx(0.99) and acc[0, 0, 33] == 0.0
