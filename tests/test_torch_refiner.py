"""Port vs JAX: StyleUNet-small (flax params carried by convert.py) and the
resampling helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar.renderer import NeuralRefiner as JRefiner
from guava_renderer_tpu.models import layers as jlayers
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner as TRefiner
from guava_renderer_tpu_torch.convert import refiner_state_dict_from_flax
from guava_renderer_tpu_torch.models import layers as tlayers

torch.set_num_threads(2)
CFG = dict(style_dim=64, num_mlp=2, channel_scale=4.0)


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [32, 64])
def test_styleunet_small_vs_flax(size):
    """atol 1e-4: the convolutions sum in another order than the flax
    im2col matmuls."""
    rng = np.random.default_rng(size)
    x = rng.uniform(0, 1, (2, size, size, 32)).astype(np.float32)
    jref = JRefiner(image_size=size, small=True, **CFG)
    params = jref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # perturb every leaf (zero-initialized biases too) so each mapping is exercised
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.01, np.shape(a)).astype(np.float32), params)
    want = np.asarray(jref.apply(params, jnp.asarray(x)))

    tref = TRefiner(image_size=size, **CFG)
    sd = refiner_state_dict_from_flax(params)
    assert set(sd) == set(tref.state_dict())
    tref.load_state_dict(sd)
    with torch.no_grad():
        got = tref(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resampling_helpers_vs_resize_bilinear():
    x = np.random.default_rng(1).normal(size=(2, 8, 12, 5)).astype(np.float32)
    up = np.asarray(jlayers.resize_bilinear(jnp.asarray(x), (16, 24)))
    np.testing.assert_allclose(tlayers.upsample2x(_nchw(x)).permute(0, 2, 3, 1).numpy(), up,
                               atol=1e-6, rtol=0)
    down = np.asarray(jlayers.downsample2x(jnp.asarray(x)))
    np.testing.assert_allclose(tlayers.downsample2x(_nchw(x)).permute(0, 2, 3, 1).numpy(), down,
                               atol=1e-6, rtol=0)
