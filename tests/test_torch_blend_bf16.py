"""Port vs JAX: the bf16-row blend (K6's plain version) and its gradient.

The JAX side is `rasterize` with `bf16_rows=True` (Pallas forward and
backward in interpret mode, chunk 8, duplication cap = the whole tile grid,
so nothing is truncated). Packing is compared bit for bit; images to atol
1e-4; gradients, after division by the JAX gradient's largest entry, to
atol 2e-4, as tests/test_torch_gsplat_grad.py holds the f32 path: both
packages blend exactly the unpacked rows they packed, and the rows differ
only by the projection's float error, which can move a lo half by one bf16
step (~2^-16 of the value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.kernels import blend as tk
from guava_renderer_tpu_torch.ops import gsplat as tgs

from test_torch_gsplat import C, _j, _t, jax_settings, make_cams, make_scene

torch.set_num_threads(2)
NAMES = ("means", "colors", "opac", "scales", "quats")
ATOL = 1e-4
GRAD_ATOL = 2e-4


def spaced_scene(seed, P=32):
    """make_scene's draws with the depths replaced by a shuffled ladder 1/P
    apart: the JAX size-class and streaming paths sort on the top bits of
    the depth and break ties by duplication order, the port by id."""
    means, colors, opac, scales, quats = make_scene(seed, P=P)
    means[:, 2] = 2.5 + np.random.default_rng(seed + 1).permutation(P).astype(np.float32) / P
    return means, colors, opac, scales, quats


def jax_vjp(arrs, size, settings):
    """JAX image (H, W, 33) and the gradients of mean((color - 0.3)^2) with
    respect to (means, colors, opacities, scales, quats)."""
    jc, _ = make_cams(size)

    def image(m, c, o, s, q):
        color, _, invd = jgs.rasterize(m, c, o, s, q, jc, jnp.zeros(C), settings,
                                       channels_first=False)
        return color, invd

    @jax.jit
    def run(*args):
        (color, invd), vjp = jax.vjp(image, *args)
        return (color, invd), vjp((2.0 * (color - 0.3) / color.size, jnp.zeros_like(invd)))

    (color, invd), grads = run(*_j(arrs))
    return (np.asarray(color), np.asarray(invd)), [np.asarray(g) for g in grads]


def torch_vjp(arrs, size, settings):
    _, tc = make_cams(size)
    args = [torch.tensor(a, requires_grad=True) for a in arrs]
    color, _, invd = tgs.rasterize(*args, tc, torch.zeros(C), settings, channels_first=False)
    ((color - 0.3) ** 2).mean().backward()
    return (color.detach().numpy(), invd.detach().numpy()), [a.grad.numpy() for a in args]


def _bits(x):
    """A bf16 array or tensor as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_pack_unpack_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    P = 97
    rows = np.zeros((P, tk.ROW), np.float32)
    rows[:, 0:2] = rng.uniform(-10, 600, (P, 2))         # pixel coordinates
    rows[:, 2:5] = rng.lognormal(-2, 2, (P, 3)) * rng.choice([-1, 1], (P, 3))
    rows[:, 5] = rng.uniform(0, 1, P)
    rows[:, 8:40] = rng.uniform(0, 1, (P, 32))
    rows[:, 40] = rng.uniform(0.02, 5, P)                 # inverse depth
    table = np.zeros((P, 128), np.float32)
    table[:, :41] = rows[:, :41]

    want = jgs._pack_rows_bf16(jnp.asarray(table))
    got = tk.pack_rows_bf16(torch.tensor(rows))
    assert got.shape == (P, tk.ROW_BF16) and got.dtype == torch.bfloat16
    n = 2 * tk.GEOM + tk.CHANNELS + 1
    np.testing.assert_array_equal(_bits(got)[:, :n], _bits(want)[:, :n])
    assert not _bits(got)[:, n:].any() and not _bits(want)[:, n:].any()

    want_rows = np.asarray(jgs._unpack_rows_bf16(want))
    got_rows = tk.unpack_rows_bf16(got).numpy()
    np.testing.assert_array_equal(got_rows[:, :41].view(np.uint32), want_rows[:, :41].view(np.uint32))
    assert not got_rows[:, 41:].any()
    # the packing is finer than bf16: hi + lo is within ~2^-16 of the value
    np.testing.assert_allclose(got_rows[:, :6], rows[:, :6], rtol=2.0 ** -15, atol=0)


@pytest.fixture(scope="module")
def case():
    arrs = spaced_scene(5)
    size, tile = 32, 16
    st = jax_settings(size, tile)._replace(chunk=8, bf16_rows=True)
    want, jgrads = jax_vjp(arrs, size, st)
    got, grads = torch_vjp(arrs, size, tgs.RasterizeSettings(tile=tile, bf16_rows=True))
    base, _ = torch_vjp(arrs, size, tgs.RasterizeSettings(tile=tile))
    return dict(want=want, got=got, base=base, jgrads=jgrads, grads=grads)


def test_rasterize_bf16_vs_jax(case):
    for g, w in zip(case["got"], case["want"]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # and it is not the f32 image: the colors went through bf16
    assert np.abs(case["got"][0] - case["base"][0]).max() > 1e-5


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_bf16_vs_jax(case, i):
    got, want = case["grads"][i], case["jgrads"][i]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 1e-7, "the reference gradient is zero: the case tests nothing"
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL)


def test_blend_bf16_is_k1_on_unpacked_rows():
    """The CPU path of K6 and of its autograd wrapper is K1's plain version
    on the unpacked rows, forward and backward."""
    arrs = make_scene(7, P=24)
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=16))
    rows = prep.rows.detach().requires_grad_(True)
    bg = torch.linspace(0, 1, C)
    color, invd, final_t = tk.blend_bf16(rows, prep.order, prep.ranges, bg, 32, 32, 16)
    (color.square().sum() + invd.sum()).backward()
    unpacked = tk.unpack_rows_bf16(tk.pack_rows_bf16(rows.detach())).requires_grad_(True)
    color2, invd2, final_t2 = tk.blend(unpacked, prep.order, prep.ranges, bg, 32, 32, 16)
    (color2.square().sum() + invd2.sum()).backward()
    for a, b in ((color, color2), (invd, invd2), (final_t, final_t2), (rows.grad, unpacked.grad)):
        assert torch.equal(a, b)
