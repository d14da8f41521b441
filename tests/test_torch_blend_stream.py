"""Port vs JAX: the streaming blend (K8's plain version) and its gradient.

The JAX side is `rasterize` with `streaming=True` (payload carried through
the instance sort, Pallas stream forward and row-gather backward in
interpret mode, chunk 8, duplication cap = the whole tile grid). Its sort
keys on the top bits of the depth and breaks ties by duplication order, so
the scene's depths are spaced (`spaced_scene`). The stream's rounded colors
are compared bit for bit, images to atol 1e-4, gradients after division by
the JAX gradient's largest entry to atol 2e-4 (the f32 path's tolerance:
both packages replay the backward on the same f32 rows).

K8 is K1's kernel with the row source `StreamRows`, which takes instance i's
row from stream row i (csrc/blend_subtile.cuh): the culled walk on the
stream with the identity order is held to `blend_stream_plain`, and the
stream's row i to the rounded row of Gaussian order[i].
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


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("seed,P", [(5, 32), (6, 24)])
def test_culled_walk_on_the_stream_is_blend_stream_plain(seed, P, tile):
    """K8's walk in PyTorch ops: the culled walk (K1's, as the kernel runs
    it) over the stream with order = arange(N), which is StreamRows' row
    rule, equals blend_stream_plain bit for bit."""
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(spaced_scene(seed, P=P)), tc, tgs.RasterizeSettings(tile=tile))
    stream = tgs.stream_rows(prep.rows, prep.order)
    bg = torch.linspace(0, 1, C)
    ids = torch.arange(stream.shape[0], dtype=torch.int32)
    got = tk.blend_culled_plain(stream, ids, prep.ranges, bg, 32, 32, tile)
    want = tk.blend_stream_plain(stream, prep.ranges, bg, 32, 32, tile)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert want[0].abs().max() > 0
    assert not tk.cull_keep_plain(stream, ids, prep.ranges, 32, 32, tile).all()


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_stream_row_i_is_instance_i(tile):
    """The address rule StreamRows relies on: the stream is one contiguous
    (N, 44) f32 block whose row i (bytes 176 i .. 176 i + 175) is the
    rounded row of Gaussian order[i], so tile t's rows are the run
    ranges[t] .. ranges[t + 1] - 1."""
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(spaced_scene(5)), tc, tgs.RasterizeSettings(tile=tile))
    stream = tgs.stream_rows(prep.rows, prep.order)
    assert stream.is_contiguous() and stream.dtype == torch.float32
    assert stream.shape == (int(prep.ranges[-1]), tk.ROW) and tk.ROW * 4 % 16 == 0
    flat = stream.reshape(-1)
    rounded = tgs.round_colors_bf16(prep.rows.detach())
    for i, gid in enumerate(prep.order.tolist()):
        assert torch.equal(flat[i * tk.ROW:(i + 1) * tk.ROW], rounded[gid])
