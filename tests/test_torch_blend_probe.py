"""Port vs JAX: K1p, the forward blend that counts the rounds each tile ran
(`kernels/blend.py:blend_probe`, `ops/gsplat.py:blend_probe`; the JAX
package's `ops/gsplat.py:blend_probe`, its Pallas blend with emit_counts).

The JAX blend runs its Pallas kernel in interpret mode. There the while
loop's condition never sees the flag its body sets (a JAX 0.9 interpreter
limit on a scratch ref read in a `while_loop` condition), so the JAX count is
ceil(n / chunk) on every tile, whatever exit_every: the TPU's compiled
kernel exits, the interpreted one does not (ROADMAP.md §3). The spread
scene of tests/test_torch_gsplat.py saturates no tile, so there the JAX
count is also the rule's and both packages must agree tile for tile. On an
opaque scene, where tiles do finish early, the port's count is held to the
Pallas body's loop stated in numpy (`pallas_body_counts`), and the JAX
interpreter's count is shown to stay at ceil(n / chunk).

K1p runs a bin tile as several sub-tile CTAs, each with its own exit test,
and the tile's count is the largest of theirs (csrc/blend_probe.cu). The
plain per-sub-tile last deaths (`blend_probe_plain(level="subtile")`) hold
that rule to the tile's count at every (chunk, exit_every), and the culled
plain walk holds the deaths to the unculled walk's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.kernels import blend as tk1
from guava_renderer_tpu_torch.ops import gsplat as tgs
from test_torch_gsplat import ATOL, C, _j, jax_settings, make_cams, make_scene

torch.set_num_threads(2)
SIZE = 64
SETTINGS = [(8, 1), (8, 4), (8, 0), (16, 1)]    # (chunk, exit_every)
SUBTILE_SETTINGS = SETTINGS + [(128, 1), (200, 3), (256, 1)]


def opaque_scene():
    """64 large, nearly opaque Gaussians over the whole 64^2 view: every
    pixel of every tile finishes (T below 1e-4) within the first ~30 of its
    tile's 64 instances."""
    rng = np.random.default_rng(5)
    P = 64
    means = np.zeros((P, 3), np.float32)
    means[:, 0] = rng.uniform(-1.0, 1.0, P)
    means[:, 1] = rng.uniform(-1.0, 1.0, P)
    means[:, 2] = rng.uniform(2.5, 3.5, P)
    colors = rng.uniform(0, 1, (P, C)).astype(np.float32)
    opac = rng.uniform(0.95, 0.999, (P, 1)).astype(np.float32)
    scales = rng.uniform(0.8, 1.6, (P, 3)).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return means, colors, opac, scales, quats


def jax_prep(arrs, tile):
    jc, _ = make_cams(SIZE)
    return jgs.rasterize_prep(*_j(arrs), jc, jax_settings(SIZE, tile))


def port_inputs(prep):
    """The JAX prep's (table, order, ranges) as the port's (rows, order, ranges)."""
    table = np.asarray(prep.table)
    rows = np.concatenate([table[:, :41], np.zeros((table.shape[0], 3), np.float32)], 1)
    ranges = np.asarray(prep.ranges)
    order = np.asarray(prep.order)[: ranges[-1]]
    return torch.tensor(rows), torch.tensor(order), torch.tensor(ranges)


def rounds_total(ranges, chunk):
    n = (ranges[1:] - ranges[:-1]).reshape(-1)
    return -(-n // chunk)


def _cumprod_doubling(x):
    """ops/gsplat.py:_cumprod_sublanes in numpy: the inclusive product down
    axis 0 by doubling steps (x[r] *= x[r - k] for k = 1, 2, 4, ...)."""
    k = 1
    while k < x.shape[0]:
        shifted = np.concatenate([np.ones_like(x[:k]), x[:-k]])
        x = x * shifted
        k *= 2
    return x


def pallas_body_counts(table, order, ranges, tile, chunk, exit_every):
    """The rounds `ops/gsplat.py:_fwd_kernel` runs per tile (the count it
    writes at :1164), its while loop stated in numpy float32: per chunk the
    alphas of `_chunk_alphas`, P = T * the doubling cumulative product of
    (1 - alpha), live = P >= 1e-4, a pixel dies where a contributing alpha
    meets a dead P, and the tile stops before chunk c + 1 once every pixel
    is dead at a check (after chunks c with c % exit_every == exit_every - 1)."""
    gx = SIZE // tile
    pix = tile * tile
    lin = np.arange(pix)
    order = np.concatenate([order, np.zeros(chunk, order.dtype)])
    counts = np.zeros(len(ranges) - 1, np.int64)
    j = np.arange(chunk)
    for t in range(len(ranges) - 1):
        px = ((t % gx) * tile + lin % tile).astype(np.float32)
        py = ((t // gx) * tile + lin // tile).astype(np.float32)
        start, num = ranges[t], ranges[t + 1] - ranges[t]
        n_chunks = -(-num // chunk)
        T = np.ones(pix, np.float32)
        dead = np.zeros(pix, bool)
        flag, c = False, 0
        while c < n_chunks and not (exit_every and flag):
            g = table[order[start + c * chunk + j]]
            d0 = g[:, 0:1] - px
            d1 = g[:, 1:2] - py
            power = np.float32(-0.5) * (g[:, 2:3] * d0 * d0 + g[:, 4:5] * d1 * d1) \
                - g[:, 3:4] * d0 * d1
            gexp = np.exp(power)
            ag = g[:, 5:6] * gexp
            mask = ((c * chunk + j) < num)[:, None] & ~dead
            at = np.where((gexp <= 1) & (ag >= np.float32(jgs.ALPHA_MIN)) & mask,
                          np.minimum(ag, np.float32(jgs.ALPHA_MAX)), np.float32(0))
            p_incl = T * _cumprod_doubling(np.float32(1) - at)
            live = p_incl >= np.float32(jgs.T_MIN)
            T = np.minimum(T, np.where(live, p_incl, np.float32(np.inf)).min(0))
            dead |= ((at > 0) & ~live).any(0)
            if exit_every and c % exit_every == exit_every - 1:
                flag = bool(dead.all())
            c += 1
        counts[t] = c
    return counts.reshape(SIZE // tile, gx)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("chunk,exit_every", SETTINGS)
def test_blend_probe_vs_jax_blend_probe(tile, chunk, exit_every):
    """The spread scene of tests/test_torch_gsplat.py:99-122: counts equal to
    the JAX count (cnt[:, :, 0, 0]) on every tile, the image within ATOL of
    the JAX image and bit-equal to the port's blend_plain."""
    prep = jax_prep(make_scene(7), tile)
    bg = np.linspace(0.0, 1.0, C).astype(np.float32)
    bg_ext = jnp.concatenate([jnp.asarray(bg), jnp.zeros(8)])
    out4, t4, cnt = jgs.blend_probe(prep.table, prep.order, prep.ranges, bg_ext, SIZE, SIZE,
                                    tile, chunk, 1, exit_every)
    want = np.asarray(jgs._tiled_to_image(out4, SIZE, SIZE, tile))
    want_t = np.asarray(jgs._tiled_to_image(t4, SIZE, SIZE, tile))[..., 0]

    rows, order, ranges = port_inputs(prep)
    color, invd, final_t, counts = tk1.blend_probe(rows, order, ranges, torch.tensor(bg), SIZE,
                                                   SIZE, tile, chunk, exit_every)
    assert counts.dtype == torch.int32 and counts.shape == (SIZE // tile, SIZE // tile)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cnt)[:, :, 0, 0])
    np.testing.assert_allclose(color.numpy(), want[..., :C], atol=ATOL, rtol=0)
    np.testing.assert_allclose(invd.numpy(), want[..., C:C + 1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy(), want_t, atol=ATOL, rtol=0)
    plain = tk1.blend_plain(rows, order, ranges, torch.tensor(bg), SIZE, SIZE, tile)
    for got, ref in zip((color, invd, final_t), plain):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("chunk,exit_every", SETTINGS)
def test_blend_probe_counts_follow_the_pallas_body(tile, chunk, exit_every):
    """The opaque scene, where tiles finish early: the port's counts equal
    the Pallas body's loop (numpy) on every tile, the tile exit fires on
    every tile when exit_every > 0, and the image is blend_plain's."""
    prep = jax_prep(opaque_scene(), tile)
    rows, order, ranges = port_inputs(prep)
    bg = torch.zeros(C)
    *img, counts = tk1.blend_probe(rows, order, ranges, bg, SIZE, SIZE, tile, chunk, exit_every)
    want = pallas_body_counts(np.asarray(prep.table), order.numpy(), ranges.numpy(), tile, chunk,
                              exit_every)
    np.testing.assert_array_equal(counts.numpy(), want)
    total = rounds_total(ranges.numpy(), chunk).reshape(want.shape)
    if exit_every:
        assert (counts.numpy() < total).all()
    else:
        np.testing.assert_array_equal(counts.numpy(), total)
    for got, ref in zip(img, tk1.blend_plain(rows, order, ranges, bg, SIZE, SIZE, tile)):
        assert torch.equal(got, ref)


def test_jax_interpreted_probe_never_exits():
    """The reference delta of the module docstring: on the opaque scene the
    interpreted JAX kernel runs ceil(n / chunk) rounds on every tile where
    its loop, stated in numpy, stops after 2 to 4 of 8. Images agree."""
    tile, chunk = 32, 8
    prep = jax_prep(opaque_scene(), tile)
    out4, _, cnt = jgs.blend_probe(prep.table, prep.order, prep.ranges, jnp.zeros(40), SIZE,
                                   SIZE, tile, chunk, 1, 1)
    rows, order, ranges = port_inputs(prep)
    total = rounds_total(ranges.numpy(), chunk).reshape(SIZE // tile, -1)
    np.testing.assert_array_equal(np.asarray(cnt)[:, :, 0, 0], total)
    body = pallas_body_counts(np.asarray(prep.table), order.numpy(), ranges.numpy(), tile, chunk,
                              1)
    assert (body < total).all()
    color, *_ = tk1.blend_probe(rows, order, ranges, torch.zeros(C), SIZE, SIZE, tile, chunk, 1)
    want = np.asarray(jgs._tiled_to_image(out4, SIZE, SIZE, tile))
    np.testing.assert_allclose(color.numpy(), want[..., :C], atol=ATOL, rtol=0)


def test_chunks_run_rule():
    """ceil(n / chunk), or the exit rounded up to a multiple of exit_every,
    capped at ceil(n / chunk); -1 (a pixel that never finishes) runs all."""
    last = torch.tensor([[5, 40, -1, 0]], dtype=torch.int32)
    ranges = torch.tensor([0, 64, 128, 192, 192], dtype=torch.int32)
    assert tk1.chunks_run(last, ranges, 8, 1).tolist() == [[1, 6, 8, 0]]
    assert tk1.chunks_run(last, ranges, 8, 4).tolist() == [[4, 8, 8, 0]]
    assert tk1.chunks_run(last, ranges, 8, 0).tolist() == [[8, 8, 8, 0]]
    assert tk1.chunks_run(last, ranges, 16, 1).tolist() == [[1, 3, 4, 0]]


def test_ops_blend_probe_layouts():
    """The host-side blend_probe on a prepped frame: rasterize_blend's image
    in both layouts, and the counts; chunk and exit_every are checked."""
    arrs = make_scene(7)
    _, tc = make_cams(SIZE)
    prep = tgs.rasterize_prep(*(torch.tensor(a) for a in arrs), tc, tgs.RasterizeSettings(tile=16))
    bg = torch.linspace(0, 1, C)
    want = tgs.rasterize_blend(prep, bg, SIZE, SIZE, tgs.RasterizeSettings(tile=16))
    color, invd, final_t, counts = tgs.blend_probe(prep, bg, SIZE, SIZE, 16, 8, 1)
    assert torch.equal(color, want[0]) and torch.equal(invd, want[1])
    assert color.shape == (C, SIZE, SIZE) and final_t.shape == (SIZE, SIZE)
    hwc = tgs.blend_probe(prep, bg, SIZE, SIZE, 16, 8, 1, channels_first=False)
    assert torch.equal(hwc[0], color.permute(1, 2, 0))
    assert torch.equal(counts, hwc[3])
    for chunk, ee in ((0, 1), (257, 1), (8, -1)):
        with pytest.raises(ValueError, match="chunk must be"):
            tgs.blend_probe(prep, bg, SIZE, SIZE, 16, chunk, ee)


@functools.lru_cache(maxsize=None)
def scene_inputs(scene, tile):
    """The port's (rows, order, ranges) of the opaque or the spread scene."""
    return port_inputs(jax_prep(opaque_scene() if scene == "opaque" else make_scene(7), tile))


@functools.lru_cache(maxsize=None)
def last_deaths(scene, tile, culled=False):
    """blend_probe_plain's image and last deaths per tile and per sub-tile."""
    rows, order, ranges = scene_inputs(scene, tile)
    bg = torch.zeros(C)
    *img, last = tk1.blend_probe_plain(rows, order, ranges, bg, SIZE, SIZE, tile, culled=culled)
    *_, sub = tk1.blend_probe_plain(rows, order, ranges, bg, SIZE, SIZE, tile, level="subtile",
                                    culled=culled)
    return img, last, sub


@pytest.mark.parametrize("scene", ["opaque", "spread"])
@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("chunk,exit_every", SUBTILE_SETTINGS)
def test_tile_count_is_the_largest_subtile_count(scene, tile, chunk, exit_every):
    """K1p's count rule: each sub-tile CTA runs chunks_run of its own last
    death, and the largest of those is chunks_run of the tile's, the count
    of the tile walked as one (the JAX kernel's)."""
    _, order, ranges = scene_inputs(scene, tile)
    _, last, sub = last_deaths(scene, tile)
    per_side = tile // tk1.subtile_side(tile)
    assert sub.shape == (SIZE // tile, SIZE // tile, per_side * per_side)
    want = tk1.chunks_run(last, ranges, chunk, exit_every)
    got = tk1.chunks_run(sub, ranges, chunk, exit_every)
    assert got.shape == sub.shape
    np.testing.assert_array_equal(got.amax(-1).numpy(), want.numpy())
    # a tile's last pixel is the last of its sub-tiles' last pixels
    np.testing.assert_array_equal(torch.where((sub >= 0).all(-1), sub.amax(-1), -1).numpy(),
                                  last.numpy())
    if scene == "opaque":      # every pixel finishes, and sub-tiles finish apart
        assert (last >= 0).all()
        if per_side > 1:
            assert (sub < last[..., None]).any()


@pytest.mark.parametrize("scene", ["opaque", "spread"])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_cull_moves_no_last_death(scene, tile):
    """The culled plain walk (each pixel skipping the rows its warp's cull
    drops, as K1p walks) gives the unculled walk's image and its last deaths
    per tile and per sub-tile: the cull cannot move a count."""
    img, last, sub = last_deaths(scene, tile)
    img_c, last_c, sub_c = last_deaths(scene, tile, culled=True)
    assert torch.equal(last_c, last) and torch.equal(sub_c, sub)
    for a, b in zip(img_c, img):
        assert torch.equal(a, b)
    rows, order, ranges = scene_inputs(scene, tile)
    keep = tk1.cull_keep_plain(rows, order, ranges, SIZE, SIZE, tile)
    if scene == "spread":      # the cull drops rows here, so the test sees it work
        assert not keep.all()


@pytest.mark.parametrize("chunk,stage", [(1, 128), (128, 128), (129, 256), (256, 256)])
def test_probe_stage_rows(chunk, stage):
    """K1's 128-row stage up to 128 rows a round, the 256-row stage past it."""
    assert tk1.probe_stage_rows(chunk) == stage
    assert chunk <= stage


def test_probe_stage_rows_rejects_chunks_outside_1_to_256():
    for chunk in (0, 257):
        with pytest.raises(ValueError, match="chunk must be"):
            tk1.probe_stage_rows(chunk)
