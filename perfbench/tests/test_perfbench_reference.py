"""The frozen reference against the port at a tiny size on the CPU: the
rasterizer alone, and whole frames at a raster size other than the
refiner's through a run of the harness (its look for a card skipped)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench import run as prun
from perfbench.reference import raster
from perfbench.tests.tiny import tiny_cell


def _gaussians(n, size, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.cat([(torch.rand(n, 2, generator=g) - 0.5) * 1.6, torch.zeros(n, 1)], 1)
    scales = torch.exp(torch.randn(n, 3, generator=g) * 0.5 - 3.5)
    quats = torch.randn(n, 4, generator=g)
    quats = quats / quats.norm(dim=1, keepdim=True)
    opac = torch.sigmoid(torch.randn(n, 1, generator=g) * 1.5)
    colors = torch.rand(n, 32, generator=g)
    return xyz, colors, opac, scales, quats


@pytest.mark.parametrize("tile,size", [(16, 64), (32, 64), (16, 48)])
def test_raster_equals_port(tile, size):
    from guava_renderer_tpu_torch.core.cameras import Camera as PortCamera
    from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings, rasterize
    from perfbench.reference.frozen.core.cameras import Camera

    xyz, colors, opac, scales, quats = _gaussians(600, size, tile + size)
    w2c = torch.eye(4)
    w2c[2, 3] = 3.0
    port_color, _, port_invd = rasterize(xyz, colors, opac, scales, quats,
                                         PortCamera.from_w2c(w2c, 0.5, size, size),
                                         torch.zeros(32), RasterizeSettings(tile=tile),
                                         channels_first=False)
    color, invd, pairs, instances = raster.rasterize(
        xyz, colors, opac, scales, quats, Camera.from_w2c(w2c, 0.5, size, size), tile, chunk=5)
    assert pairs > 0 and instances >= 600 // 4
    torch.testing.assert_close(color, port_color, rtol=0, atol=2e-6)
    torch.testing.assert_close(invd, port_invd[..., 0], rtol=0, atol=2e-6)


def test_raster_gradients_equal_port():
    """The reference's gradients (autograd through the checkpointed walk, the
    0.99 clamp passed as the identity) against the port's backward (the
    plain version of K3 on the CPU)."""
    from guava_renderer_tpu_torch.core.cameras import Camera as PortCamera
    from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings, rasterize
    from perfbench.reference.frozen.core.cameras import Camera

    size, tile = 48, 16
    w2c = torch.eye(4)
    w2c[2, 3] = 3.0
    g = torch.Generator().manual_seed(3)
    wc, wd = torch.randn(size, size, 32, generator=g), torch.randn(size, size, generator=g)
    grads = []
    for side in ("port", "reference"):
        inputs = [t.clone().requires_grad_(True) for t in _gaussians(300, size, 9)]
        if side == "port":
            color, _, invd = rasterize(*inputs, PortCamera.from_w2c(w2c, 0.5, size, size),
                                       torch.zeros(32), RasterizeSettings(tile=tile),
                                       channels_first=False)
            invd = invd[..., 0]
        else:
            color, invd, _, _ = raster.rasterize(*inputs, Camera.from_w2c(w2c, 0.5, size, size),
                                                 tile, chunk=7, grad=True)
        ((color * wc).sum() + (invd * wd).sum()).backward()
        grads.append([t.grad for t in inputs])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * float(a.abs().max()))


def test_frame_equals_port_through_a_run():
    cell = tiny_cell(size=64, refiner=32)
    run, out = prun.run_cell(cell.name, 2 ** 40 + 3, 1.5, False, torch.device("cpu"), cell)
    assert out["correct"] and run.attempted >= 2
    assert set(out["checks"]) == {"render_rel_rms", "raw_rel_rms", "invdepth_rel_rms"}
    for c in out["checks"].values():
        assert c["value"] < 1e-5
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert math.isfinite(out["metrics"]["frames_per_s"]["value"])
    assert run.counts["pairs_per_frame"] > 0 and run.counts["refiner_flops"] > 0


def test_inputs_repeat_under_a_seed():
    from perfbench.inputs import avatar_draws, fill_weights

    a = avatar_draws(3, 2 ** 45 + 9, 7, 16, "cpu")
    b = avatar_draws(3, 2 ** 45 + 9, 7, 16, "cpu")
    c = avatar_draws(3, 10, 7, 16, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].shape == c[k].shape
    assert not torch.equal(a["uv_colors"], c["uv_colors"])
    assert torch.equal(a["uv_scales"], c["uv_scales"])       # the geometry is the avatar seed's
    m1, m2 = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    assert fill_weights(m1, 5) == fill_weights(m2, 5) == 15
    assert torch.equal(m1.weight, m2.weight) and float(m1.bias.detach().abs().sum()) == 0.0
    assert np.isclose(float(m1.weight.detach().std()), 0.5, atol=0.35)
