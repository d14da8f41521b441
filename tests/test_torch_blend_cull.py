"""The exact row cull and the sub-tile cut of the blend kernels K1 and K3
(`csrc/blend_subtile.cuh`), through their plain versions in
`kernels/blend.py`, on the CPU.

(a) The plain box minimum and cut equal the JAX package's `_slot_qmin` and
    `_cull_qcut` on seeded draws, at 16^2 and 8^2 boxes (the JAX test is
    square; the kernels' warp boxes are 8 x 4): within 2e-6 of
    the largest quadratic term over the box (float32 rounding of the same
    expressions, which XLA may fuse), the cut within 1e-6 relative.
(b) The cull is conservative: over random, near-degenerate and
    non-positive-definite conics and opacities near 1/255, at 8 x 4, 8^2
    and 16^2 boxes, no dropped (row, box) has a pixel centre with
    power <= 0 and alpha * exp(power) >= 1/255 in the plain versions'
    float32 order.
(c) The walk over each warp's kept rows (`blend_culled_plain`) equals
    `blend_plain` bit for bit, on a 64^2 frame of the bench scene (the
    port's binning is uncapped, the zero-truncation instance set of
    `benchscene.EXACT_LADDER`) and on the JAX package's test scenes.
(d) The backward: `blend_bwd_plain` over sub-tiles of their kept rows
    equals the whole-tile `blend_bwd_plain` to 1e-5 of each column's
    largest gradient (float32 sums over other pixel groups).
(e) `subtile_geometry` gives the CTA count and pixel map the kernels use
    at tiles 8, 16 and 32, and `cull_boxes` the 8 x 4 box of each warp.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.avatar.deformer import deform_avatar
from guava_renderer_tpu_torch.benchscene import make_bench_scene
from guava_renderer_tpu_torch.kernels import blend as k1
from guava_renderer_tpu_torch.ops.gsplat import bin_gaussians, pack_rows
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians

from test_torch_gsplat import _t, dense_scene, make_cams, make_scene

torch.set_num_threads(2)
QMIN_ATOL = 2e-6       # share of the largest quadratic term over the box
QCUT_RTOL = 1e-6
BWD_TOL = 1e-5         # share of a column's largest gradient


def _conics(rng, n):
    """Positive definite conics of 2D covariances R diag(s^2) R^T + 0.3 I
    (the projection's dilation), with their means and opacities."""
    th = rng.uniform(0, np.pi, n)
    s = rng.uniform(0.3, 30.0, (n, 2))
    c, sn = np.cos(th), np.sin(th)
    cov_a = c * c * s[:, 0] ** 2 + sn * sn * s[:, 1] ** 2 + 0.3
    cov_b = c * sn * (s[:, 0] ** 2 - s[:, 1] ** 2)
    cov_c = sn * sn * s[:, 0] ** 2 + c * c * s[:, 1] ** 2 + 0.3
    det = cov_a * cov_c - cov_b ** 2
    conic = np.stack([cov_c / det, -cov_b / det, cov_a / det], -1).astype(np.float32)
    return conic


@pytest.mark.parametrize("side", [16, 8])
def test_box_qmin_and_qcut_equal_jax(side):
    rng = np.random.default_rng(side)
    n, cap = 512, 6
    conic = _conics(rng, n)
    mean = rng.uniform(-40, 200, (n, 2)).astype(np.float32)
    alpha = np.concatenate([rng.uniform(0.0, 1.0, n - 8), [0.0, 1 / 255, 0.5 / 255, 1.0,
                                                           0.99, 2 / 255, 1e-6, 0.3]])
    alpha = alpha.astype(np.float32)
    tx = rng.integers(0, 12, (n, cap)).astype(np.int32)
    ty = rng.integers(0, 12, (n, cap)).astype(np.int32)
    want = np.asarray(jgs._slot_qmin(jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(mean[:, 0]),
                                     jnp.asarray(mean[:, 1]), *(jnp.asarray(conic[:, i])
                                                                for i in range(3)), side))
    bx0 = torch.tensor(tx * side, dtype=torch.float32) - torch.tensor(mean[:, :1])
    by0 = torch.tensor(ty * side, dtype=torch.float32) - torch.tensor(mean[:, 1:])
    tconic = torch.tensor(conic)[:, None, :]
    got = k1.box_qmin_plain(bx0, by0, float(side - 1), float(side - 1), tconic).numpy()
    ex = np.maximum(np.abs(bx0.numpy()), np.abs(bx0.numpy() + side - 1))
    ey = np.maximum(np.abs(by0.numpy()), np.abs(by0.numpy() + side - 1))
    ca, cb, cc = (conic[:, None, i] for i in range(3))
    largest = ca * ex * ex + 2 * np.abs(cb) * ex * ey + cc * ey * ey
    assert (want == 0).any() and (want > 0).any()
    assert np.all(np.abs(got - want) <= QMIN_ATOL * largest), np.max(np.abs(got - want) / largest)

    # the cut, with non-positive-definite conics among them
    bad = conic.copy()
    bad[::7, 1] = np.sqrt(bad[::7, 0] * bad[::7, 2]) * 1.01
    bad[1::7, 0] = -bad[1::7, 0]
    bad[2::7, 2] = 0.0
    want_cut = np.asarray(jgs._cull_qcut(jnp.asarray(bad), jnp.asarray(alpha)))
    got_cut = k1.cull_qcut_plain(torch.tensor(bad), torch.tensor(alpha)).numpy()
    assert np.array_equal(np.isinf(want_cut), np.isinf(got_cut))
    assert np.isinf(got_cut).sum() >= 3 * 73
    fin = np.isfinite(want_cut)
    np.testing.assert_allclose(got_cut[fin], want_cut[fin], rtol=QCUT_RTOL, atol=0)


def _contributing(geom, x0, y0, w, h):
    """Whether any pixel centre of the w x h box passes the blend's tests, in
    the plain versions' float32 order (kernels/blend.py:_walk_plain)."""
    lin = torch.arange(w * h)
    px = (x0 + lin % w).float()
    py = (y0 + lin // w).float()
    d0 = geom[0] - px
    d1 = geom[1] - py
    power = -0.5 * (geom[2] * d0 * d0 + geom[4] * d1 * d1) - geom[3] * d0 * d1
    ag = geom[5] * torch.exp(power)
    return bool(((power <= 0.0) & (ag >= k1.ALPHA_MIN)).any())


@st.composite
def _rows(draw):
    """A row (x, y, a, b, c, alpha) and a box: conics that are random,
    near-degenerate (b^2 within 1e-7..1e-2 of a c) or not positive definite;
    opacities near 1/255 or anywhere in [0, 1]; means near the box, far from
    it, or placed so that q at one pixel centre of the box is within -1e-3
    .. 1e-2 of the cut, along any direction (where rounding decides)."""
    w, h = draw(st.sampled_from([(8, 4), (8, 8), (16, 16)]))
    x0 = draw(st.integers(0, 60)) * 8
    y0 = draw(st.integers(0, 120)) * 4
    kind = draw(st.sampled_from(["random", "degenerate", "not_pd"]))
    a = draw(st.floats(1e-4, 4.0))
    c = draw(st.floats(1e-4, 4.0))
    sign = draw(st.sampled_from([-1.0, 1.0]))
    if kind == "random":
        b = sign * draw(st.floats(0.0, 0.999)) * math.sqrt(a * c)
    elif kind == "degenerate":
        b = sign * math.sqrt(a * c * (1.0 - draw(st.floats(1e-7, 1e-2))))
    else:
        b = sign * math.sqrt(a * c) * draw(st.floats(1.0, 1.5))
        a = a * draw(st.sampled_from([1.0, -1.0]))
    alpha = draw(st.one_of(st.floats(1 / 255 * 0.999, 1 / 255 * 1.05),
                           st.floats(0.0, 1.0)))
    where = draw(st.sampled_from(["near", "far", "boundary"]))
    if where == "boundary" and kind != "not_pd":
        px = x0 + draw(st.integers(0, w - 1))
        py = y0 + draw(st.integers(0, h - 1))
        th = draw(st.floats(0.0, 2 * math.pi))
        ux, uy = math.cos(th), math.sin(th)
        quad = a * ux * ux + 2 * b * ux * uy + c * uy * uy
        target = (2 * math.log(max(255 * alpha, 1.0)) + 1e-3) * (1 + draw(st.floats(-1e-3, 1e-2)))
        dist = math.sqrt(target / quad) if quad > 0 else 0.0
        mx, my = px + dist * ux, py + dist * uy
    else:
        reach = 600.0 if where == "far" else 40.0
        mx = x0 + draw(st.floats(-reach, reach + w))
        my = y0 + draw(st.floats(-reach, reach + h))
    geom = torch.tensor([mx, my, a, b, c, alpha], dtype=torch.float32)
    return geom, x0, y0, w, h


@settings(max_examples=600, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_rows())
def test_cull_is_conservative(case):
    geom, x0, y0, w, h = case
    keep = bool(k1.row_may_reach_plain(geom, torch.tensor(float(x0)), torch.tensor(float(y0)),
                                       float(w - 1), float(h - 1)))
    if not keep:
        assert not _contributing(geom, x0, y0, w, h), (geom.tolist(), x0, y0, w, h)


def test_cull_keeps_non_finite_rows_and_drops_far_ones():
    far = torch.tensor([500.0, 500.0, 1.0, 0.0, 1.0, 0.9])
    assert not bool(k1.row_may_reach_plain(far, torch.tensor(0.0), torch.tensor(0.0), 7.0, 3.0))
    for i, v in ((0, math.nan), (2, math.inf), (5, math.nan), (3, -math.inf)):
        g = far.clone()
        g[i] = v
        assert bool(k1.row_may_reach_plain(g, torch.tensor(0.0), torch.tensor(0.0), 7.0, 3.0))


def _bench_frame(size):
    sc = make_bench_scene(size, size, 21, 7, device="cpu")
    with torch.no_grad():
        gs = deform_avatar(sc.avatar, sc.ehm, sc.faces, sc.base_body, sc.base_flame)
        proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0],
                                 sc.cam)
        return proj, pack_rows(proj, gs.colors[0]), size


def _scene_frame(make, size):
    means, colors, opac, scales, quats = _t(make())
    _, cam = make_cams(size)
    proj = project_gaussians(means, scales, quats, opac, cam)
    return proj, pack_rows(proj, colors), size


FRAMES = {"bench64": lambda: _bench_frame(64), "spread": lambda: _scene_frame(
    lambda: make_scene(7), 64), "dense": lambda: _scene_frame(dense_scene, 32)}


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request):
    return FRAMES[request.param]()


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_culled_walk_equals_blend_plain_bit_for_bit(frame, tile):
    proj, rows, size = frame
    if size % tile:
        pytest.skip("image smaller than the tile")
    ranges, order = bin_gaussians(proj, size, size, tile)
    bg = torch.linspace(0.0, 0.5, 32)
    keep = k1.cull_keep_plain(rows, order, ranges, size, size, tile)
    assert keep.shape == (order.numel(), tile * tile // 32)
    got = k1.blend_culled_plain(rows, order, ranges, bg, size, size, tile)
    want = k1.blend_plain(rows, order, ranges, bg, size, size, tile)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if size == 64:     # the cull has work to do
        assert 0 < int((~keep).sum()) < keep.numel()


def _subtile_binning(keep, order, ranges, height, width, tile):
    """The kept instances of each sub-tile as a binning at tile = side
    (sub-tiles row-major over the image), in their order within the tile."""
    side = k1.subtile_side(tile)
    per = tile // side
    gx = width // tile
    sgx, sgy = width // side, height // side
    counts = (ranges[1:] - ranges[:-1]).long()
    tile_of = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    s = torch.arange(per * per)
    sub_id = ((tile_of // gx)[:, None] * per + s // per) * sgx + (tile_of % gx)[:, None] * per \
        + s % per                                                        # (N, per^2)
    pos = torch.arange(order.numel())[:, None].expand_as(sub_id)
    sid, p = sub_id[keep], pos[keep]
    key = sid * (order.numel() + 1) + p
    idx = torch.argsort(key)
    sub_order = order[p[idx]]
    sub_counts = torch.bincount(sid, minlength=sgx * sgy)
    sub_ranges = torch.cat([torch.zeros(1, dtype=torch.long), sub_counts.cumsum(0)])
    return sub_order.to(torch.int32), sub_ranges.to(torch.int32)


@pytest.mark.parametrize("tile", [16, 32])
def test_subtile_backward_equals_blend_bwd_plain(frame, tile):
    proj, rows, size = frame
    if size % tile:
        pytest.skip("image smaller than the tile")
    ranges, order = bin_gaussians(proj, size, size, tile)
    bg = torch.linspace(0.0, 0.5, 32)
    color, invd, final_t = k1.blend_plain(rows, order, ranges, bg, size, size, tile)
    gen = torch.Generator().manual_seed(3)
    g_color = torch.randn((size, size, 32), generator=gen)
    g_invd = torch.randn((size, size, 1), generator=gen)
    keep = k1.cull_keep_plain(rows, order, ranges, size, size, tile, level="subtile")
    sub_order, sub_ranges = _subtile_binning(keep, order, ranges, size, size, tile)
    side = k1.subtile_side(tile)
    got = k1.blend_bwd_plain(rows, sub_order, sub_ranges, bg, color, invd, final_t, g_color,
                             g_invd, side)
    want = k1.blend_bwd_plain(rows, order, ranges, bg, color, invd, final_t, g_color, g_invd,
                              tile)
    scale = want.abs().amax(0)
    assert float(scale.max()) > 0
    assert bool(((got - want).abs() <= BWD_TOL * scale).all())


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_subtile_geometry(tile):
    height, width = 64, 96
    geo = k1.subtile_geometry(height, width, tile)
    side = min(tile, 16)
    per = (tile // side) ** 2
    assert (geo.side, geo.per_tile, geo.threads) == (side, per, side * side)
    assert geo.n_ctas == (height // tile) * (width // tile) * per
    assert geo.px.shape == (geo.n_ctas, geo.threads)
    # every pixel exactly once
    lin = (geo.py * width + geo.px).flatten()
    assert torch.equal(torch.sort(lin).values, torch.arange(height * width))
    # CTA t * per + s lies in bin tile t, and its pixels form one side^2 square
    gx = width // tile
    cta = torch.arange(geo.n_ctas)
    t = cta // per
    assert bool(((geo.px // tile) == (t % gx)[:, None]).all())
    assert bool(((geo.py // tile) == (t // gx)[:, None]).all())
    assert bool(((geo.px.amax(1) - geo.px.amin(1)) == side - 1).all())
    assert bool(((geo.py.amax(1) - geo.py.amin(1)) == side - 1).all())
    # each warp an 8 x 4 block
    wx = geo.px.reshape(geo.n_ctas, -1, 32)
    wy = geo.py.reshape(geo.n_ctas, -1, 32)
    assert bool(((wx.amax(2) - wx.amin(2)) == 7).all())
    assert bool(((wy.amax(2) - wy.amin(2)) == 3).all())
    # the cull's boxes: each warp's 8 x 4 block, each sub-tile's square, and the box of
    # every pixel of a tile as the plain walk looks it up
    lin = (geo.py % tile) * tile + geo.px % tile
    for level, group, spans in (("warp", 32, (7, 3)), ("subtile", side * side, (side - 1,) * 2)):
        x0, y0, sx, sy, box_of = k1.cull_boxes(tile, level)
        assert x0.numel() == tile * tile // group
        assert bool((sx == spans[0]).all()) and bool((sy == spans[1]).all())
        own = box_of[lin[:per]].reshape(per, -1, group)     # the first bin tile's CTAs
        assert torch.equal(own, torch.arange(x0.numel()).reshape(per, -1, 1).expand_as(own))


def test_subtile_geometry_of_a_tile_that_is_not_a_multiple_of_8():
    geo = k1.subtile_geometry(24, 36, 12)
    assert (geo.side, geo.per_tile, geo.threads, geo.n_ctas) == (12, 1, 160, 6)
    held = geo.px >= 0
    assert int(held.sum()) == 24 * 36 and bool((held.sum(1) == 144).all())
