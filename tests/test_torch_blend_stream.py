"""Port vs JAX: the streaming blend (K8's plain version) and its gradient.

The JAX side is `rasterize` with `streaming=True` (payload carried through
the instance sort, Pallas stream forward and row-gather backward in
interpret mode, chunk 8, duplication cap = the whole tile grid). Its sort
keys on the top bits of the depth and breaks ties by duplication order, so
the scene's depths are spaced (`spaced_scene`). The stream's rounded colors
are compared bit for bit, images to atol 1e-4, gradients after division by
the JAX gradient's largest entry to atol 2e-4 (the f32 path's tolerance:
both packages replay the backward on the same f32 rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.kernels import blend as tk
from guava_renderer_tpu_torch.ops import gsplat as tgs

from test_torch_blend_bf16 import ATOL, GRAD_ATOL, NAMES, jax_vjp, spaced_scene, torch_vjp
from test_torch_gsplat import C, _t, jax_settings, make_cams

torch.set_num_threads(2)


def test_rounded_colors_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    P = 61
    colors = rng.uniform(0, 1, (P, C)).astype(np.float32)
    invd = rng.uniform(0.02, 5, P).astype(np.float32)
    want = np.asarray(jgs._unpack_colors_bf16(jgs._pack_colors_bf16(
        jnp.asarray(colors), jnp.asarray(invd))))
    rows = torch.zeros((P, tk.ROW))
    rows[:, :6] = torch.tensor(rng.uniform(0, 64, (P, 6)).astype(np.float32))
    rows[:, 8:40] = torch.tensor(colors)
    rows[:, 40] = torch.tensor(invd)
    got = tgs.round_colors_bf16(rows).numpy()
    np.testing.assert_array_equal(got[:, 8:41].view(np.uint32), want[:, :33].view(np.uint32))
    np.testing.assert_array_equal(got[:, :8], rows[:, :8].numpy())     # geometry exact


def test_stream_rows_are_the_sorted_rows():
    arrs = spaced_scene(5)
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=16))
    stream = tgs.stream_rows(prep.rows, prep.order)
    assert not stream.requires_grad and stream.shape == (prep.order.shape[0], tk.ROW)
    assert torch.equal(stream, tgs.round_colors_bf16(prep.rows.detach())[prep.order.long()])


@pytest.fixture(scope="module")
def case():
    arrs = spaced_scene(5)
    size, tile = 32, 16
    st = jax_settings(size, tile)._replace(chunk=8, streaming=True)
    want, jgrads = jax_vjp(arrs, size, st)
    got, grads = torch_vjp(arrs, size, tgs.RasterizeSettings(tile=tile, streaming=True))
    return dict(want=want, got=got, jgrads=jgrads, grads=grads)


def test_rasterize_stream_vs_jax(case):
    for g, w in zip(case["got"], case["want"]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_stream_vs_jax(case, i):
    got, want = case["grads"][i], case["jgrads"][i]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 1e-7, "the reference gradient is zero: the case tests nothing"
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL)


def test_stream_blend_is_k1_on_rounded_rows():
    """K8's plain version on the stream renders what K1's renders on the
    rounded per-Gaussian rows, and the stream path's gradient is K3's on
    the f32 rows."""
    arrs = spaced_scene(6, P=24)
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=16))
    bg = torch.linspace(0, 1, C)
    rows = prep.rows.detach().requires_grad_(True)
    out = tk.blend_stream(rows, tgs.stream_rows(rows, prep.order), prep.order, prep.ranges, bg,
                          32, 32, 16)
    want = tk.blend_plain(tgs.round_colors_bf16(rows.detach()), prep.order, prep.ranges, bg,
                          32, 32, 16)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    g_color, g_invd = torch.randn_like(out[0]), torch.randn_like(out[1])
    ((out[0] * g_color).sum() + (out[1] * g_invd).sum()).backward()
    d_rows = tk.blend_bwd_plain(rows.detach(), prep.order, prep.ranges, bg, out[0].detach(),
                                out[1].detach(), out[2], g_color, g_invd, 16)
    assert rows.grad.abs().max() > 0 and torch.equal(rows.grad, d_rows)
