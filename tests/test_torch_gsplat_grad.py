"""Port vs JAX: gradients of `rasterize` with respect to means, colors,
opacities, scales and quats, against `jax.grad` of the JAX `rasterize`
(Pallas backward in interpret mode) and against autograd through the port's
dense oracle `rasterize_reference`.

Zero-truncation configurations only (the JAX duplication cap is the whole
tile grid). Gradients are compared after division by the reference
gradient's largest entry, atol 2e-4, as tests/test_gsplat.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.ops import gsplat as tgs
from guava_renderer_tpu_torch.ops.gsplat_project import mark_visible, project_gaussians
from guava_renderer_tpu_torch.ops.gsplat_reference import rasterize_reference

from test_torch_gsplat import C, _j, _t, jax_settings, make_cams, make_scene

torch.set_num_threads(2)
NAMES = ("means", "colors", "opac", "scales", "quats")
ATOL = 2e-4


def border_scene():
    """Splats on the x = 16 px tile border of a 32^2 image (tile 16), wide
    enough to straddle both tiles: short per-tile runs, every Gaussian in
    several tiles (tests/test_gsplat.py, border-straddling short runs)."""
    rng = np.random.default_rng(42)
    P = 6
    means = np.zeros((P, 3), np.float32)
    means[:, 0] = rng.normal(0, 0.002, P)
    means[:, 1] = rng.uniform(-0.3, 0.3, P)
    means[:, 2] = rng.uniform(2.5, 3.5, P)
    colors = rng.uniform(0, 1, (P, C)).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, (P, 1)).astype(np.float32)
    scales = rng.uniform(0.1, 0.2, (P, 3)).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return means, colors, opac, scales, quats


def culled_scene():
    """The spread scene plus Gaussians behind the camera, on the camera
    plane (z = 0 exactly) and far off screen."""
    means, colors, opac, scales, quats = make_scene(7, P=24)
    means[0, 2] = -2.0
    means[1, 2] = 0.0
    means[2, 2] = 0.1
    means[3, 0] = 40.0
    means[4, 1] = -40.0
    return means, colors, opac, scales, quats


SCENES = {
    # name: (arrays, size, tile, which output the loss reads)
    "color": (lambda: make_scene(7, P=32), 32, 16, "color"),
    "border": (border_scene, 32, 16, "color"),
    "invdepth": (lambda: make_scene(7, P=32), 32, 16, "invdepth"),
    "culled": (culled_scene, 32, 16, "color"),
    "tile32": (lambda: make_scene(9, P=32), 64, 32, "color"),
}


def _torch_grads(fn, arrs, tc, bg, size, which, **kw):
    args = [torch.tensor(a, requires_grad=True) for a in arrs]
    color, _, invd = fn(*args, tc, torch.tensor(bg), **kw)
    if which == "color":
        loss = ((color - 0.3) ** 2).mean()
    else:
        loss = ((invd - 0.4) ** 2).mean()
    loss.backward()
    return float(loss.detach()), [np.zeros(a.shape, np.float32) if a.grad is None
                                  else a.grad.numpy() for a in args]


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make, size, tile, which = SCENES[request.param]
    arrs = make()
    jc, tc = make_cams(size)
    bg = np.zeros(C, np.float32)
    st = jax_settings(size, tile)

    def jloss(m, c, o, s, q):
        color, _, invd = jgs.rasterize(m, c, o, s, q, jc, jnp.asarray(bg), st)
        if which == "color":
            return jnp.mean((color - 0.3) ** 2)
        return jnp.mean((invd - 0.4) ** 2)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(arrs))
    val, grads = _torch_grads(tgs.rasterize, arrs, tc, bg, size, which,
                              settings=tgs.RasterizeSettings(tile=tile))
    rval, rgrads = _torch_grads(rasterize_reference, arrs, tc, bg, size, which, tile=tile)
    return dict(name=request.param, which=which, val=val, grads=grads,
                jval=float(jval), jgrads=[np.asarray(g) for g in jgrads],
                rval=rval, rgrads=rgrads)


def test_loss_agrees(case):
    # the images agree to 1e-7 (tests/test_torch_gsplat.py); the float32 mean
    # over 32 x size^2 values is summed in another order by XLA
    np.testing.assert_allclose(case["val"], case["jval"], rtol=5e-4)
    np.testing.assert_allclose(case["val"], case["rval"], rtol=1e-5)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_vs_jax(case, i):
    got, want = case["grads"][i], case["jgrads"][i]
    assert np.isfinite(got).all()
    if case["which"] == "invdepth" and NAMES[i] == "colors":
        assert not got.any() and not want.any()
        return
    if case["name"] == "culled":
        # a Gaussian on the camera plane (z = 0) makes the JAX gradient NaN,
        # which its train step scrubs; the port gives it zero. Hold the rest.
        assert np.isfinite(want[5:]).all()
        got, want = got[5:], want[5:]
    scale = np.abs(want).max() + 1e-8
    assert scale > 1e-7, "the reference gradient is zero: the case tests nothing"
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_vs_dense_oracle(case, i):
    got, want = case["grads"][i], case["rgrads"][i]
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL)


def test_culled_gaussians_get_zero_not_nan():
    arrs = culled_scene()
    _, tc = make_cams(32)
    _, grads = _torch_grads(tgs.rasterize, arrs, tc, np.zeros(C, np.float32), 32, "color",
                            settings=tgs.RasterizeSettings(tile=16))
    for name, g in zip(NAMES, grads):
        assert np.isfinite(g).all(), name
        assert not g[:5].any(), f"{name}: a culled Gaussian has a gradient"
        assert g[5:].any(), name
    vis = mark_visible(torch.tensor(arrs[0]), tc)
    assert vis.tolist()[:5] == [False, False, False, True, True] and bool(vis[5:].all())
    proj = project_gaussians(*_t((arrs[0], arrs[3], arrs[4], arrs[2])), tc)
    assert not bool(proj.valid[:3].any())
    for f in (proj.mean2d, proj.conic, proj.alpha, proj.depth):
        assert bool(torch.isfinite(f).all())


def test_opacity_gradient_finite_difference():
    """Central differences on three opacities (tests/test_gsplat.py:181)."""
    arrs = make_scene(3, P=8)
    _, tc = make_cams(16)
    bg = torch.zeros(C)
    m, c, o, s, q = _t(arrs)

    def loss(op):
        out, _, _ = tgs.rasterize(m, c, op, s, q, tc, bg, tgs.RasterizeSettings(tile=16))
        return (out[:4] ** 2).sum()

    op = o.clone().requires_grad_(True)
    loss(op).backward()
    eps = 1e-3
    for i in (0, 3, 5):
        do = torch.zeros_like(o)
        do[i, 0] = eps
        fd = float(loss(o + do) - loss(o - do)) / (2 * eps)
        np.testing.assert_allclose(float(op.grad[i, 0]), fd, rtol=5e-2, atol=1e-4)


def test_bg_gradient():
    arrs = make_scene(7, P=16)
    _, tc = make_cams(32)
    bg = torch.full((C,), 0.5, requires_grad=True)
    color, _, _ = tgs.rasterize(*_t(arrs), tc, bg, tgs.RasterizeSettings(tile=16))
    color.sum().backward()
    bg2 = torch.full((C,), 0.5, requires_grad=True)
    ref, _, _ = rasterize_reference(*_t(arrs), tc, bg2, tile=16)
    ref.sum().backward()
    np.testing.assert_allclose(bg.grad.numpy(), bg2.grad.numpy(), rtol=1e-5)
    assert float(bg.grad.min()) > 0
