"""Port vs JAX: the plain version of K3 (the blend backward) against
`jax.grad` through `blend_tiles`, whose custom_vjp runs the Pallas backward
kernel in interpret mode, on the same rows, order and ranges.

Every one of the 39 row gradients (mean x/y, conic a/b/c, opacity, 32
colors, inverse depth) and d bg is held to rtol 1e-4 with atol 1e-5 of that
column's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.kernels import blend as tk1

from test_torch_gsplat import C, _j, dense_scene, jax_settings, make_cams, make_scene

torch.set_num_threads(2)
RTOL, ATOL_REL = 1e-4, 1e-5
COLUMNS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "alpha", "pad6", "pad7",
           *(f"color{c}" for c in range(C)), "invdepth")


def corner_scene():
    """All splats in one corner of the image: most tiles are empty."""
    means, colors, opac, scales, quats = make_scene(3, P=24, spread=0.2)
    means[:, 0] -= 0.9
    means[:, 1] -= 0.9
    return means, colors, opac, scales, quats


SCENES = {
    # name: (arrays, image size, tile)
    "spread16": (lambda: make_scene(7), 64, 16),
    "spread32": (lambda: make_scene(7), 64, 32),
    "dense": (dense_scene, 32, 16),          # opaque and crowded: pixels saturate, alpha clamps
    "corner": (corner_scene, 64, 16),        # empty tiles
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make, size, tile = SCENES[request.param]
    arrs = make()
    jc, _ = make_cams(size)
    st = jax_settings(size, tile)
    prep = jgs.rasterize_prep(*_j(arrs), jc, st)
    rng = np.random.default_rng(5)
    bg = rng.uniform(0.0, 1.0, C).astype(np.float32)
    w_img = rng.normal(size=(size, size, C + 1)).astype(np.float32)

    def loss(table, bg32):
        bg_ext = jnp.concatenate([bg32, jnp.zeros(8)])
        out4, _ = jgs.blend_tiles(table, prep.order, prep.ranges, bg_ext, size, size, tile,
                                  st.chunk)
        img = jgs._tiled_to_image(out4, size, size, tile)
        return jnp.sum(img[..., :C + 1] * jnp.asarray(w_img))

    d_table, d_bg = jax.grad(loss, argnums=(0, 1))(prep.table, jnp.asarray(bg))

    table = np.asarray(prep.table)
    rows = np.concatenate([table[:, :41], np.zeros((table.shape[0], 3), np.float32)], 1)
    ranges = np.asarray(prep.ranges)
    order = np.asarray(prep.order)[: ranges[-1]]
    return dict(name=request.param, size=size, tile=tile, rows=torch.tensor(rows),
                order=torch.tensor(order), ranges=torch.tensor(ranges), bg=torch.tensor(bg),
                w_img=torch.tensor(w_img), d_table=np.asarray(d_table), d_bg=np.asarray(d_bg))


def test_scene_has_what_it_is_for(case):
    """The dense scene saturates pixels and clamps alpha; the corner scene
    has empty tiles."""
    c = case
    _, _, final_t = tk1.blend_plain(c["rows"], c["order"], c["ranges"], c["bg"], c["size"],
                                    c["size"], c["tile"])
    counts = (c["ranges"][1:] - c["ranges"][:-1]).numpy()
    if c["name"] == "dense":
        assert float(final_t.min()) < 2e-4 * 100      # some pixel ran down to the stop
        assert float(c["rows"][:, 5].max()) > tk1.ALPHA_MAX
    if c["name"] == "corner":
        assert (counts == 0).sum() >= 8 and counts.max() > 0
    assert np.abs(c["d_table"]).max() > 0


def _plain_grads(c):
    rows = c["rows"].clone().requires_grad_(True)
    bg = c["bg"].clone().requires_grad_(True)
    color, invd, _ = tk1.blend(rows, c["order"], c["ranges"], bg, c["size"], c["size"],
                               c["tile"])
    (torch.cat([color, invd], -1) * c["w_img"]).sum().backward()
    return rows.grad.numpy(), bg.grad.numpy()


@pytest.mark.parametrize("col", range(41), ids=COLUMNS)
def test_row_gradient_vs_jax(case, col):
    got, _ = _cached(case)
    want = case["d_table"][:, col]
    if col in (6, 7):
        assert not got[:, col].any() and not want.any()
        return
    np.testing.assert_allclose(got[:, col], want, rtol=RTOL,
                               atol=ATOL_REL * max(np.abs(want).max(), 1e-30))


def test_bg_gradient_vs_jax(case):
    _, got = _cached(case)
    want = case["d_bg"][:C]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * np.abs(want).max())


def test_pad_columns_stay_zero(case):
    got, _ = _cached(case)
    assert not got[:, 41:].any()


_grads = {}


def _cached(c):
    if c["name"] not in _grads:
        _grads[c["name"]] = _plain_grads(c)
    return _grads[c["name"]]


def test_backward_function_matches_wrapper(case):
    """`blend_bwd` on CPU tensors is the plain version, and the autograd
    Function hands it the forward's own outputs."""
    c = case
    color, invd, final_t = tk1.blend_plain(c["rows"], c["order"], c["ranges"], c["bg"],
                                           c["size"], c["size"], c["tile"])
    g = c["w_img"]
    d_rows = tk1.blend_bwd(c["rows"], c["order"], c["ranges"], c["bg"], color, invd, final_t,
                           g[..., :C].contiguous(), g[..., C:].contiguous(), c["tile"])
    got, _ = _cached(c)
    np.testing.assert_array_equal(d_rows.numpy(), got)
    assert tk1.bwd_launches == 0 and tk1.launches == 0     # CPU tensors launch nothing


def test_final_t_carries_no_gradient():
    rows = torch.zeros(4, tk1.ROW, requires_grad=True)
    order = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(5, dtype=torch.int32)
    _, _, final_t = tk1.blend(rows, order, ranges, torch.zeros(C), 32, 32, 16)
    assert not final_t.requires_grad


def test_blend_bwd_rejects_bad_inputs():
    rows = torch.zeros(4, tk1.ROW)
    order = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(5, dtype=torch.int32)
    bg = torch.zeros(C)
    color, invd, final_t = tk1.blend(rows, order, ranges, bg, 32, 32, 16)
    g = torch.zeros(32, 32, C)
    with pytest.raises(ValueError):          # g_invdepth must be (H, W, 1)
        tk1.blend_bwd(rows, order, ranges, bg, color, invd, final_t, g, torch.zeros(32, 32), 16)
    with pytest.raises(ValueError):          # float64 gradients are not taken
        tk1.blend_bwd(rows, order, ranges, bg, color, invd, final_t, g.double(),
                      torch.zeros(32, 32, 1), 16)
