"""The port's random init (`models/styleunet.py:init_params_`, gain 1) has
the flax initialisers' scale, leaf by leaf: the inferer at the widths of
`test_torch_inferer.py` (5-block ViT, 16^2 chart), initialised by
`UbodyGaussianInferer.init` in the JAX package and by `init_params_` in the
port, the leaves matched by the flax names `convert.py` carries.

A leaf that flax fills with a constant (zeros, ones) is that constant in
the port. A random leaf of n >= 256 entries has the same standard deviation
within 6 / sqrt(2 n) of it (six standard errors of a sample deviation; the
flax draw is a normal truncated at 2 sigma and rescaled to the same
variance) and a mean within 6 / sqrt(n) of it.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar import inferer as jinf
from guava_renderer_tpu.bodymodel import synthetic_ehm as jsynthetic_ehm
from guava_renderer_tpu_torch.avatar import inferer as tinf
from guava_renderer_tpu_torch.convert import inferer_state_dict_from_flax
from guava_renderer_tpu_torch.models.styleunet import init_params_

from test_torch_inferer import CFG, FEAT, RIG

torch.set_num_threads(2)
MIN_RANDOM = 256


@pytest.fixture(scope="module")
def leaves():
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "cv2", None)
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        smplx, _, extras = jsynthetic_ehm(**RIG)
    finally:
        mp.undo()
    V = smplx.num_vertices
    jmod = jinf.UbodyGaussianInferer(cfg=jinf.InfererConfig(**CFG), num_vertices=V)
    U = CFG["uvmap_size"]
    params = jax.jit(jmod.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, FEAT, FEAT, 3)), jnp.eye(4)[None],
        jnp.zeros((1, V, 3)), jnp.zeros((1, U, U)), jnp.asarray(extras.uvmap_f_idx),
        jnp.asarray(extras.uvmap_f_bary, jnp.float32), jnp.asarray(smplx.faces))
    flax = inferer_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    port = tinf.UbodyGaussianInferer(tinf.InfererConfig(**CFG), V)
    with torch.no_grad():
        init_params_(port, torch.Generator().manual_seed(0), gain=1.0)
    return flax, port.state_dict()


def test_same_leaves(leaves):
    flax, port = leaves
    assert set(flax) == set(port)
    for k, v in flax.items():
        assert v.shape == port[k].shape, k


def test_constant_leaves_equal(leaves):
    flax, port = leaves
    n_const = 0
    for k, v in flax.items():
        if v.numel() > 1 and bool((v == v.flatten()[0]).all()):
            n_const += 1
            assert torch.equal(port[k], v), k
    assert n_const > 20


def test_random_leaves_same_scale(leaves):
    flax, port = leaves
    n_random = 0
    for k, v in flax.items():
        n = v.numel()
        if n < MIN_RANDOM or bool((v == v.flatten()[0]).all()):
            continue
        n_random += 1
        sf, sp = float(v.std()), float(port[k].std())
        assert abs(sp / sf - 1.0) <= 6.0 / np.sqrt(2 * n), (k, sf, sp)
        assert abs(float(port[k].mean()) - float(v.mean())) <= 6.0 * sf / np.sqrt(n), k
    assert n_random > 50


# A narrow but full-depth inferer (512^2 chart, 12-block ViT, 8 mapping layers)
# for `main`: the widths are cut, the depth is not.
DEEP_CFG = dict(image_size=512, uvmap_size=512, invtanfov=24.0, dino_out_dim=8, uv_out_dim=16,
                smplx_fea_dim=16, prj_out_dim=16, global_vertex_dim=32, uv_base_dim=8,
                style_dim=64, num_mlp=8, channel_scale=8.0, vit_dim=64, vit_depth=12,
                vit_heads=4, pyramid_dims=(16, 16, 16, 16))


def main(draws=6):
    """Print, for `draws` seeds, the UV offsets (mean and max |local_pos|) and
    mean |colour| of the port's forward at DEEP_CFG on the bench rig's
    518^2 source, once on the flax init (converted) and once on the port's
    own init at gain 1, and the port/flax std ratio of every leaf of >= 4096
    entries averaged over the draws. ~6 minutes on 4 CPU threads.

        JAX_PLATFORMS=cpu python tests/test_torch_init_scale.py
    """
    from guava_renderer_tpu_torch.avatar.inferer import texel_visibility
    from guava_renderer_tpu_torch.benchscene import make_create_scene
    from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward
    from guava_renderer_tpu_torch.cli.inference import _batched_params, _unpack_params
    from guava_renderer_tpu_torch.convert import inferer_from_flax

    torch.set_num_threads(4)
    sys.modules["cv2"] = None
    sc = make_create_scene(512, 512, 21, 7, feat_size=518, device="cpu")
    V = sc.smplx.num_vertices
    f_idx, f_bary, mask = sc.uv_tables
    img = sc.source["image"][None]
    w2c = sc.source["w2c"][None]
    body, flame = _unpack_params(_batched_params(sc.source["params"], torch.device("cpu")))
    with torch.no_grad():
        verts = ehm_forward(sc.ehm, body, flame).vertices
        texels, _ = texel_visibility(verts, sc.faces, torch.tensor(w2c), f_idx, mask, 512, 24.0)
    jmod = jinf.UbodyGaussianInferer(cfg=jinf.InfererConfig(**DEEP_CFG), num_vertices=V)
    init = jax.jit(jmod.init)

    def offsets(m):
        with torch.no_grad():
            uv = m(torch.tensor(img), torch.tensor(w2c), verts, texels.float(), f_idx, f_bary,
                   sc.faces)[1]
        lp = uv["local_pos"].abs()
        colors = float(uv["colors"].abs().mean())
        return f"{float(lp.mean()):.4g} / {float(lp.max()):.4g} / {colors:.4g}"

    ratios = {}
    for seed in range(draws):
        params = init(jax.random.PRNGKey(seed), jnp.asarray(img), jnp.asarray(w2c),
                      jnp.zeros((1, V, 3)), jnp.zeros((1, 512, 512)), jnp.asarray(f_idx.numpy()),
                      jnp.asarray(f_bary.numpy()), jnp.asarray(sc.faces.numpy()))
        flax = inferer_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                 tinf.InfererConfig(**DEEP_CFG), V, device="cpu")
        port = tinf.UbodyGaussianInferer(tinf.InfererConfig(**DEEP_CFG), V)
        with torch.no_grad():
            init_params_(port, torch.Generator().manual_seed(seed), gain=1.0)
        for (k, a), b in zip(flax.state_dict().items(), port.state_dict().values()):
            if a.numel() >= 4096:
                ratios.setdefault(k, []).append(float(b.std() / a.std()))
        print(f"draw {seed}: mean |offset| / max |offset| / mean |colour|: flax init "
              f"{offsets(flax)}; port init {offsets(port)}", flush=True)
    r = np.array([np.mean(v) for v in ratios.values()])
    print(f"{len(r)} leaves of >= 4096 entries, port/flax std over {draws} draws: min "
          f"{r.min():.4f}, median {np.median(r):.4f}, max {r.max():.4f}")


if __name__ == "__main__":
    main()
