"""Port vs JAX: `resize_bilinear` in its three modes at the ratios the
creation path uses, `harmonic_embedding`, and the strided and transposed
convolutions with their flax kernels carried over by convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from guava_renderer_tpu.models import layers as jlayers
from guava_renderer_tpu_torch.convert import state_dict_from_flax
from guava_renderer_tpu_torch.models import layers as tlayers

torch.set_num_threads(2)


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


# (n_in, n_out, align_corners, antialias): the sites of dpt_encoder.py,
# inferer.py, vit.py and styleunet.py
RESIZES = [
    (518, 148, False, True), (518, 74, False, True), (518, 37, False, True),
    (518, 19, False, True), (518, 512, False, True),        # RGB pyramid, source image
    (37, 74, False, False), (148, 296, False, False), (296, 512, False, False),
    (518, 512, False, False), (19, 37, False, False),       # F.interpolate sites
    (37, 74, True, True), (74, 296, True, True),            # align-corners low-level path
    (37, 16, False, True), (16, 37, False, True),           # position-embedding grid
    (28, 32, False, True), (2, 4, True, True), (1, 2, True, True),   # micro widths
]


@pytest.mark.parametrize("n_in,n_out,align,antialias", RESIZES)
def test_resize_bilinear_vs_jax(n_in, n_out, align, antialias):
    """atol 2e-6: same weight matrices, the two products sum in another order."""
    rng = np.random.default_rng(n_in * 1000 + n_out)
    # non-square on purpose: rows and columns take different matrices
    x = rng.normal(size=(2, n_in, max(n_in // 2, 1), 3)).astype(np.float32)
    size = (n_out, max(n_out // 2, 1))
    want = np.asarray(jlayers.resize_bilinear(jnp.asarray(x), size, align_corners=align,
                                              antialias=antialias))
    got = _nhwc(tlayers.resize_bilinear(_nchw(x), size, align_corners=align,
                                        antialias=antialias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("n_in,n_out,antialias", [(518, 148, True), (37, 74, False),
                                                  (518, 512, False), (8, 4, True)])
def test_halfpix_weights_equal(n_in, n_out, antialias):
    np.testing.assert_array_equal(tlayers._halfpix_weights(n_in, n_out, antialias),
                                  jlayers._halfpix_weights(n_in, n_out, antialias))


@pytest.mark.parametrize("n_in,n_out", [(37, 74), (74, 296), (1, 2), (5, 1)])
def test_align_corners_weights_equal(n_in, n_out):
    np.testing.assert_array_equal(tlayers._ac_weights(n_in, n_out),
                                  np.asarray(jlayers._ac_weights(n_in, n_out, jnp.float32)))


def test_resize_same_size_is_identity():
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    assert tlayers.resize_bilinear(x, (3, 4)) is x


@pytest.mark.parametrize("n_freqs,include_input", [(4, True), (2, False)])
def test_harmonic_embedding_vs_jax(n_freqs, include_input):
    """atol 1e-6: sin/cos of the same float32 products."""
    x = np.random.default_rng(0).normal(size=(3, 5, 3)).astype(np.float32)
    want = np.asarray(jlayers.harmonic_embedding(jnp.asarray(x), n_freqs, include_input))
    got = tlayers.harmonic_embedding(torch.tensor(x), n_freqs, include_input).numpy()
    assert got.shape == want.shape == (3, 5, 3 * (2 * n_freqs + include_input))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


class _Convs(nn.Module):
    """The conv kinds of the DPT encoder under the names convert.py keys on."""

    @nn.compact
    def __call__(self, x):
        a = nn.ConvTranspose(6, (4, 4), strides=(4, 4), name="resize0")(x)
        b = nn.ConvTranspose(6, (2, 2), strides=(2, 2), name="resize1")(x)
        c = jlayers.Conv(6, (3, 3), strides=(2, 2), padding=1, name="resize3")(x)
        d = jlayers.Conv(6, (3, 3), padding=1, use_bias=False, name="layer_rn0")(x)
        return a, b, c, d


def test_strided_and_transposed_conv_vs_flax():
    """atol 1e-5 on O(1) outputs. flax ConvTranspose does not flip its
    kernel, `nn.ConvTranspose2d` does: the converter's flip is what is held."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 5, 4)).astype(np.float32)
    mod = _Convs()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(np.float32), params)
    want = mod.apply(params, jnp.asarray(x))

    sd = state_dict_from_flax(params)
    tmods = {
        "resize0": torch.nn.ConvTranspose2d(4, 6, 4, stride=4),
        "resize1": torch.nn.ConvTranspose2d(4, 6, 2, stride=2),
        "resize3": tlayers.conv(4, 6, 3, stride=2),
        "layer_rn0": tlayers.conv(4, 6, 3, bias=False),
    }
    for (name, m), w in zip(tmods.items(), want):
        m.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()
                           if k.startswith(name + ".")})
        with torch.no_grad():
            got = _nhwc(m(_nchw(x)))
        assert got.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
