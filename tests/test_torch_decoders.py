"""Port vs JAX: the two Gaussian decoders, flax params carried over by
convert.py, at B = 2 so that the vertex-axis normalisation shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.models.decoders import UVPointGSDecoder as JUV
from guava_renderer_tpu.models.decoders import VertexGSDecoder as JVertex
from guava_renderer_tpu_torch.convert import state_dict_from_flax
from guava_renderer_tpu_torch.models.decoders import UVPointGSDecoder as TUV
from guava_renderer_tpu_torch.models.decoders import VertexGSDecoder as TVertex

torch.set_num_threads(2)
FIELDS = ("colors", "opacities", "scales", "rotations")


def _perturbed(params, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, scale, np.shape(a)).astype(np.float32), params)


def _load(module, params):
    sd = state_dict_from_flax(params)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    return module.eval()


@pytest.fixture(scope="module")
def vertex_outputs():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 50, 32)).astype(np.float32)
    feats[1] *= 3.0            # the two items' rotations get different norms
    dirs = rng.normal(size=(2, 27)).astype(np.float32)
    jdec = JVertex(in_dim=32, color_dim=32)
    params = _perturbed(jdec.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(dirs)),
                        rng)
    want = jdec.apply(params, jnp.asarray(feats), jnp.asarray(dirs))
    tdec = _load(TVertex(in_dim=32, color_dim=32), params)
    with torch.no_grad():
        got = tdec(torch.tensor(feats), torch.tensor(dirs))
    return got, want


@pytest.mark.parametrize("field", FIELDS)
def test_vertex_decoder_vs_flax(vertex_outputs, field):
    """atol 1e-5: small dense layers, outputs O(1) or below."""
    got, want = vertex_outputs
    assert got[field].shape == want[field].shape
    np.testing.assert_allclose(got[field].numpy(), np.asarray(want[field]), atol=1e-5, rtol=0)


def test_vertex_rotation_normalised_over_vertices(vertex_outputs):
    got, want = vertex_outputs
    assert got["static_offsets"] is None and want["static_offsets"] is None
    rot = got["rotations"]
    torch.testing.assert_close(torch.linalg.norm(rot, dim=1), torch.ones(2, 4),
                               atol=1e-5, rtol=0)
    assert not torch.allclose(torch.linalg.norm(rot, dim=-1), torch.ones(2, 50), atol=1e-2)
    assert float(got["scales"].max()) <= 0.05


@pytest.fixture(scope="module")
def uv_outputs():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)
    dirs = rng.normal(size=(2, 27)).astype(np.float32)
    jdec = JUV(in_dim=12, color_dim=32)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(dirs))
    params = _perturbed(params, rng, scale=0.02)
    # push some scale exponents over the clamp at 8
    params["params"]["scale1"]["bias"] = params["params"]["scale1"]["bias"] + np.array(
        [9.0, 0.0, -3.0], np.float32)
    want = jdec.apply(params, jnp.asarray(feats), jnp.asarray(dirs))
    tdec = _load(TUV(in_dim=12, color_dim=32), params)
    with torch.no_grad():
        got = tdec(torch.tensor(feats).permute(0, 3, 1, 2), torch.tensor(dirs))
    return got, want


@pytest.mark.parametrize("field", FIELDS + ("local_pos",))
def test_uv_decoder_vs_flax(uv_outputs, field):
    """atol 1e-4 on the bounded fields; the scales are exp of an exponent
    that agrees to ~1e-5, so they are held relatively, rtol 1e-4."""
    got, want = uv_outputs
    g, w = got[field].numpy(), np.asarray(want[field])
    assert g.shape == w.shape and g.shape[:3] == (2, 16, 16)
    if field == "scales":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
    else:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_uv_scale_clamped(uv_outputs):
    got, _ = uv_outputs
    s = got["scales"]
    assert float(s.max()) == pytest.approx(np.exp(8.0), rel=1e-6)
    assert float((s == s.max()).float().mean()) > 0.05
    torch.testing.assert_close(torch.linalg.norm(got["rotations"], dim=-1),
                               torch.ones(2, 16, 16), atol=1e-5, rtol=0)
