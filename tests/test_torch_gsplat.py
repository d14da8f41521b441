"""Port vs JAX: projection, uncapped binning, the plain K1 blend and rasterize.

The JAX blend runs its Pallas kernel in interpret mode. Its duplication
cap is set to the whole tile grid, so it truncates nothing and binning can
be compared instance for instance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu.ops.gsplat_project import project_gaussians as jproject
from guava_renderer_tpu.ops.gsplat_reference import rasterize_reference
from guava_renderer_tpu_torch.convert import camera_from_numpy
from guava_renderer_tpu_torch.kernels import blend as tk1
from guava_renderer_tpu_torch.ops import gsplat as tgs
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians as tproject

torch.set_num_threads(2)
C = 32
ATOL = 2e-5   # as tests/test_gsplat.py holds the Pallas blend to the dense oracle


def make_scene(seed, P=64, spread=0.5, z0=3.0, opacity_hi=0.9):
    """The scenes of tests/test_gsplat.py (same draws)."""
    rng = np.random.default_rng(seed)
    means = np.zeros((P, 3), np.float32)
    means[:, 0] = rng.uniform(-spread, spread, P)
    means[:, 1] = rng.uniform(-spread, spread, P)
    means[:, 2] = rng.uniform(z0 - 0.5, z0 + 0.5, P)
    colors = rng.uniform(0, 1, (P, C)).astype(np.float32)
    opac = rng.uniform(0.2, opacity_hi, (P, 1)).astype(np.float32)
    scales = rng.uniform(0.02, 0.08, (P, 3)).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return means, colors, opac, scales, quats


def dense_scene():
    means, colors, opac, scales, quats = make_scene(11, P=128, spread=0.15, opacity_hi=0.999)
    return means, colors, np.clip(opac * 1.2, 0, 0.999).astype(np.float32), scales, quats


def make_cams(size):
    jc = JCamera(R=jnp.eye(3), t=jnp.zeros(3), tanfovx=jnp.asarray(0.5),
                 tanfovy=jnp.asarray(0.5), width=size, height=size)
    return jc, camera_from_numpy(jc, "cpu")


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _t(arrs):
    return tuple(torch.tensor(a) for a in arrs)


def jax_settings(size, tile):
    return jgs.RasterizeSettings(tile=tile, max_tiles_per_gaussian=(size // tile) ** 2)


@pytest.mark.parametrize("scale_modifier,antialiasing", [(1.0, False), (1.3, True)])
def test_project_gaussians_vs_jax(scale_modifier, antialiasing):
    means, _, opac, scales, quats = make_scene(7)
    jc, tc = make_cams(64)
    want = jproject(*_j((means, scales, quats, opac)), jc, scale_modifier, antialiasing)
    got = tproject(*_t((means, scales, quats, opac)), tc, scale_modifier, antialiasing)
    for name in ("mean2d", "conic", "alpha", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    for name in ("radius", "radius_bin", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("scene", ["spread", "dense"])
def test_binning_equals_jax_presort(tile, scene):
    means, _, opac, scales, quats = make_scene(7) if scene == "spread" else dense_scene()
    size = 64
    jc, tc = make_cams(size)
    jp = jproject(*_j((means, scales, quats, opac)), jc)
    contributing = jp.valid & (jp.alpha >= jgs.ALPHA_MIN)
    st = jax_settings(size, tile)
    j_ranges, j_order, n_valid, n_trunc = jgs.bin_gaussians(
        jp.mean2d, jp.depth, jp.radius_bin, contributing, size, size, st)
    assert int(n_trunc) == 0
    ranges, order = tgs.bin_gaussians(tproject(*_t((means, scales, quats, opac)), tc),
                                      size, size, tile)
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(j_ranges))
    assert order.shape[0] == int(n_valid)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order)[: int(n_valid)])


@pytest.mark.parametrize("tile", [16, 32])
def test_plain_blend_vs_pallas_blend_tiles(tile):
    """Same (table, order, ranges) into JAX blend_tiles and the plain K1."""
    size = 64
    means, colors, opac, scales, quats = make_scene(7)
    jc, _ = make_cams(size)
    st = jax_settings(size, tile)
    prep = jgs.rasterize_prep(*_j((means, colors, opac, scales, quats)), jc, st)
    bg = np.linspace(0.0, 1.0, C).astype(np.float32)
    bg_ext = jnp.concatenate([jnp.asarray(bg), jnp.zeros(8)])
    out4, t4 = jgs.blend_tiles(prep.table, prep.order, prep.ranges, bg_ext, size, size,
                               tile, st.chunk)
    want = np.asarray(jgs._tiled_to_image(out4, size, size, tile))
    want_t = np.asarray(jgs._tiled_to_image(t4, size, size, tile))[..., 0]

    table = np.asarray(prep.table)
    rows = np.concatenate([table[:, :41], np.zeros((table.shape[0], 3), np.float32)], 1)
    ranges = np.asarray(prep.ranges)
    order = np.asarray(prep.order)[: ranges[-1]]
    color, invd, final_t = tk1.blend(torch.tensor(rows), torch.tensor(order),
                                     torch.tensor(ranges), torch.tensor(bg), size, size, tile)
    np.testing.assert_allclose(color.numpy(), want[..., :C], atol=ATOL, rtol=0)
    np.testing.assert_allclose(invd.numpy(), want[..., C:C + 1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy(), want_t, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tile", [16, 32])
def test_rasterize_prep_and_blend_vs_jax(tile):
    """The two halves of rasterize: prep fields equal JAX's (rows to the
    projection's 1e-5; the JAX order carries a chunk of padding), and
    rasterize_blend in both layouts. JAX's tile cull is off here: it drops
    instances whose ellipse misses the tile, which the port keeps and the
    blend skips, so only the images would agree."""
    size = 64
    arrs = make_scene(7)
    jc, tc = make_cams(size)
    st = jax_settings(size, tile)._replace(tile_cull=False)
    settings = tgs.RasterizeSettings(tile=tile)
    jprep = jgs.rasterize_prep(*_j(arrs), jc, st)
    prep = tgs.rasterize_prep(*_t(arrs), tc, settings)
    ranges = np.asarray(jprep.ranges)
    np.testing.assert_array_equal(prep.ranges.numpy(), ranges)
    np.testing.assert_array_equal(prep.order.numpy(), np.asarray(jprep.order)[: ranges[-1]])
    np.testing.assert_array_equal(prep.radius.numpy(), np.asarray(jprep.radius))
    np.testing.assert_allclose(prep.rows[:, :41].numpy(), np.asarray(jprep.table)[:, :41],
                               atol=1e-5, rtol=1e-6)
    bg = np.linspace(0.0, 1.0, C).astype(np.float32)
    for channels_first in (True, False):
        want = jgs.rasterize_blend(jprep, jnp.asarray(bg), size, size, st, channels_first)
        got = tgs.rasterize_blend(prep, torch.tensor(bg), size, size, settings, channels_first)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("scene", ["spread", "dense"])
def test_rasterize_vs_jax_and_reference(tile, scene):
    arrs = make_scene(7) if scene == "spread" else dense_scene()
    size = 64 if scene == "spread" else 32
    jc, tc = make_cams(size)
    bg = np.linspace(0.0, 1.0, C).astype(np.float32)
    st = jax_settings(size, tile)
    want, want_r, want_i = jgs.rasterize(*_j(arrs), jc, jnp.asarray(bg), st)
    ref, _, ref_i = rasterize_reference(*_j(arrs), jc, jnp.asarray(bg), tile=tile)
    got, radii, invd = tgs.rasterize(*_t(arrs), tc, torch.tensor(bg),
                                     tgs.RasterizeSettings(tile=tile))
    np.testing.assert_array_equal(radii.numpy(), np.asarray(want_r))
    for w, wi in ((want, want_i), (ref, ref_i)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(invd.numpy(), np.asarray(wi), atol=ATOL, rtol=0)


def test_empty_scene_gives_background():
    _, tc = make_cams(32)
    bg = torch.linspace(0.2, 0.8, C)
    out, radii, invd = tgs.rasterize(
        torch.tensor([[0.0, 0.0, -5.0]]), torch.ones(1, C), torch.ones(1, 1),
        torch.full((1, 3), 0.05), torch.tensor([[1.0, 0, 0, 0]]), tc, bg)
    assert int(radii[0]) == 0
    np.testing.assert_allclose(out.numpy(), bg[:, None, None].expand(C, 32, 32).numpy(), atol=1e-6)
    np.testing.assert_allclose(invd.numpy(), 0.0, atol=1e-7)


def test_blend_rejects_bad_inputs():
    rows = torch.zeros(4, tk1.ROW)
    order = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(5, dtype=torch.int32)
    bg = torch.zeros(C)
    with pytest.raises(ValueError):      # 32x32 image does not tile by 24
        tk1.blend(rows, order, ranges, bg, 32, 32, 24)
    with pytest.raises(ValueError):      # the TPU's 128-lane rows are not taken
        tk1.blend(torch.zeros(4, 128), order, ranges, bg, 32, 32, 16)
    with pytest.raises(ValueError):      # ranges must cover the 4 tiles
        tk1.blend(rows, order, torch.zeros(4, dtype=torch.int32), bg, 32, 32, 16)
