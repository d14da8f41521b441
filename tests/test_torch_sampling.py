"""Port vs JAX: `grid_sample` with both paddings and coordinates far
outside [-1, 1], `project_to_ndc`, and torch's own F.grid_sample as a
second reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from guava_renderer_tpu.avatar import sampling as jsampling
from guava_renderer_tpu_torch.avatar import sampling as tsampling

torch.set_num_threads(2)


def _inputs(seed, lead):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    coords = rng.uniform(-1.6, 1.6, (2,) + lead + (2,)).astype(np.float32)
    flat = coords.reshape(2, -1, 2)
    # corners, exact edges, and points far outside
    flat[0, :6] = [[-1, -1], [1, 1], [-1, 1], [0, 0], [5.0, -7.0], [-30.0, 40.0]]
    flat[1, :3] = [[1.0001, 0.3], [-0.9999, -1.0001], [100.0, 100.0]]
    return feats, flat.reshape(coords.shape)


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("lead", [(40,), (6, 5)])
def test_grid_sample_vs_jax(padding, lead):
    """atol 1e-6: the same four taps and weights in float32."""
    feats, coords = _inputs(len(lead), lead)
    want = np.asarray(jsampling.grid_sample(jnp.asarray(feats), jnp.asarray(coords), padding))
    got = tsampling.grid_sample(torch.tensor(feats), torch.tensor(coords), padding).numpy()
    assert got.shape == want.shape == (2,) + lead + (5,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample_vs_torch_functional(padding):
    """atol 1e-5 against F.grid_sample(align_corners=False), whose border
    mode clips the coordinate where this one clamps each tap."""
    feats, coords = _inputs(7, (40,))
    got = tsampling.grid_sample(torch.tensor(feats), torch.tensor(coords), padding)
    want = F.grid_sample(torch.tensor(feats).permute(0, 3, 1, 2), torch.tensor(coords)[:, None],
                         mode="bilinear", padding_mode=padding, align_corners=False)
    np.testing.assert_allclose(got.numpy(), want[:, :, 0].permute(0, 2, 1).numpy(),
                               atol=1e-5, rtol=0)


def test_grid_sample_rejects_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        tsampling.grid_sample(torch.zeros(1, 2, 2, 1), torch.zeros(1, 3, 2), "reflect")


@pytest.mark.parametrize("lead", [(11,), (4, 3)])
def test_project_to_ndc_vs_jax(lead):
    """atol 1e-5 on NDC values of O(1)."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2,) + lead + (3,)).astype(np.float32)
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    w2c[:, :3, :3] += rng.normal(0, 0.1, (2, 3, 3)).astype(np.float32)
    w2c[:, :3, 3] = [0.1, -0.2, 6.0]
    want = np.asarray(jsampling.project_to_ndc(jnp.asarray(pts), jnp.asarray(w2c), 3.0))
    got = tsampling.project_to_ndc(torch.tensor(pts), torch.tensor(w2c), 3.0).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
