"""Port vs JAX: the micro ViT and the DINO+DPT encoder at the widths of
`testing.make_micro_pipeline` (28^2 source, 64-dim 5-block ViT, pyramid
16), flax params carried over by convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.models.dpt_encoder import DinoDPTEncoder as JEncoder
from guava_renderer_tpu.models.vit import VisionTransformer as JViT
from guava_renderer_tpu_torch.convert import state_dict_from_flax
from guava_renderer_tpu_torch.models.dpt_encoder import DinoDPTEncoder as TEncoder
from guava_renderer_tpu_torch.models.vit import VisionTransformer as TViT

torch.set_num_threads(2)
VIT = dict(dim=64, depth=5, num_heads=4)


def _perturbed(params, rng, scale=0.05):
    """Every leaf moved off its initial value (zero biases, unit gammas,
    the zero CLS token), so each mapping of the converter is exercised."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, scale, np.shape(a)).astype(np.float32), params)


def _load(module, params):
    sd = state_dict_from_flax(params)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    return module.eval()


@pytest.mark.parametrize("side,pos_grid", [(28, 37), (42, 3)])
def test_vit_vs_flax(side, pos_grid):
    """atol 1e-4 on layer-normed tokens (O(1)): matmuls and the softmax sum
    in another order. pos_grid != the token grid takes the resized
    position embedding, pos_grid == it the stored one."""
    rng = np.random.default_rng(side)
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    jvit = JViT(pos_grid=pos_grid, num_intermediate=3, **VIT)
    params = _perturbed(jax.jit(jvit.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(jvit.apply)(params, jnp.asarray(x))

    tvit = _load(TViT(pos_grid=pos_grid, num_intermediate=3, **VIT), params)
    with torch.no_grad():
        got = tvit(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1 + (side // 14) ** 2, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("side,out", [(28, 32), (42, 24)])
def test_dino_dpt_encoder_vs_flax(side, out):
    """atol 2e-4 on the feature maps: five levels of convolutions and
    resizes in float32, outputs O(1)."""
    rng = np.random.default_rng(side)
    x = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    kw = dict(out_dim_1=4, out_dim_2=8, hidden=4, output_size=out, vit_dim=64, vit_depth=5,
              vit_heads=4, pyramid_dims=(16, 16, 16, 16))
    jenc = JEncoder(**kw)
    params = _perturbed(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(jenc.apply)(params, jnp.asarray(x))

    tenc = _load(TEncoder(**kw), params)
    with torch.no_grad():
        got = tenc(torch.tensor(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"f_map1", "f_map2", "f_global"}
    for k, ch in (("f_map1", 4), ("f_map2", 8)):
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == (2, out, out, ch)
        np.testing.assert_allclose(g, np.asarray(want[k]), atol=2e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["f_global"].numpy(), np.asarray(want["f_global"]),
                               atol=1e-4, rtol=0)


def test_f_global_is_first_patch_token():
    """The global feature is token 1 (the first patch), not CLS."""
    rng = np.random.default_rng(0)
    enc = TEncoder(out_dim_1=4, out_dim_2=8, hidden=4, output_size=16, vit_dim=64, vit_depth=5,
                   vit_heads=4, pyramid_dims=(16, 16, 16, 16)).eval()
    for p in enc.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.tensor(rng.uniform(0, 1, (1, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        tokens = enc.dino((x - enc.mean) / enc.std)
        got = enc(x)["f_global"]
    torch.testing.assert_close(got, tokens[-1][:, 1])
    assert not torch.allclose(got, tokens[-1][:, 0])
