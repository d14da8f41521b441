"""Port vs JAX: `UbodyGaussianInferer` and `build_avatar` at the widths of
`testing.make_micro_pipeline` (28^2 source, 32^2 image, 16^2 chart, 64-dim
5-block ViT), flax params carried over by `convert.inferer_from_flax`.

Tolerances: 1e-4 absolute on every bounded field (the network is ~40
float32 layers deep; measured ~1e-6); the UV scales are exp of an exponent
and are held relatively, rtol 1e-3.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar import inferer as jinf
from guava_renderer_tpu.bodymodel import synthetic_ehm as jsynthetic_ehm
from guava_renderer_tpu.bodymodel.ehm import BodyParams as JBody
from guava_renderer_tpu.bodymodel.ehm import EhmModel as JEhm
from guava_renderer_tpu.bodymodel.ehm import FlameParams as JFlame
from guava_renderer_tpu_torch.avatar import inferer as tinf
from guava_renderer_tpu_torch.bodymodel.ehm import BodyParams, EhmModel, FlameParams, ehm_forward
from guava_renderer_tpu_torch.bodymodel.synthetic import synthetic_ehm
from guava_renderer_tpu_torch.convert import inferer_from_flax, inferer_state_dict_from_flax

torch.set_num_threads(2)
RIG = dict(body_side=12, head_side=6, n_shape=8, n_exp=4, uv_size=16)
CFG = dict(image_size=32, uvmap_size=16, invtanfov=3.0, dino_out_dim=4, uv_out_dim=8,
           smplx_fea_dim=8, prj_out_dim=8, global_vertex_dim=16, uv_base_dim=4, style_dim=32,
           num_mlp=2, channel_scale=16.0, vit_dim=64, vit_depth=5, vit_heads=4,
           pyramid_dims=(16, 16, 16, 16))
FEAT = 28
ATOL = 1e-4
SCALE_RTOL = 1e-3
GS_FIELDS = ("colors", "opacities", "scales", "rotations")


def _source(rng, B, n_shape, n_exp):
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    w2c[:, 2, 3] = 6.0
    w2c[:, 0, 3] = np.linspace(-0.05, 0.05, B)
    return {
        "image": rng.uniform(0, 1, (B, FEAT, FEAT, 3)).astype(np.float32),
        "w2c": w2c,
        "shape": (rng.normal(size=(B, n_shape)) * 0.1).astype(np.float32),
        "body_pose": (rng.normal(size=(B, 21, 3)) * 0.05).astype(np.float32),
        "flame_exp": (rng.normal(size=(B, n_exp)) * 0.1).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world():
    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jrig = jsynthetic_ehm(**RIG)
    finally:
        mp.undo()
    trig = synthetic_ehm(**RIG)
    jehm = JEhm.build(*jrig)
    tehm = EhmModel.build(*trig, device="cpu")
    smplx, _, extras = trig
    V = smplx.num_vertices
    jcfg, tcfg = jinf.InfererConfig(**CFG), tinf.InfererConfig(**CFG)
    jmod = jinf.UbodyGaussianInferer(cfg=jcfg, num_vertices=V)
    rng = np.random.default_rng(0)
    src = _source(rng, 1, smplx.n_shape, smplx.n_exp)
    tables = (np.asarray(extras.uvmap_f_idx), np.asarray(extras.uvmap_f_bary, np.float32),
              np.asarray(extras.uvmap_mask))
    params = jax.jit(jmod.init)(
        jax.random.PRNGKey(0), jnp.asarray(src["image"]), jnp.asarray(src["w2c"]),
        jnp.zeros((1, V, 3)), jnp.zeros((1, 16, 16)), jnp.asarray(tables[0]),
        jnp.asarray(tables[1]), jnp.asarray(smplx.faces))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, np.shape(a)).astype(np.float32), params)
    tmod = inferer_from_flax(params, tcfg, V, device="cpu")
    return dict(jehm=jehm, tehm=tehm, smplx=smplx, tables=tables, jmod=jmod, tmod=tmod,
                params=params, faces=np.asarray(smplx.faces))


def test_rig_tables_equal(world):
    """Both packages build the same synthetic rig, empty texels (-1) included."""
    f_idx, _, mask = world["tables"]
    assert (f_idx < 0).any() and not mask.all()
    for k, v in world["jehm"].smplx.items():
        np.testing.assert_allclose(world["tehm"].smplx[k].numpy(), np.asarray(v), atol=1e-6,
                                   err_msg=k)


def test_converter_fills_every_parameter(world):
    sd = inferer_state_dict_from_flax(world["params"])
    want = world["tmod"].state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    n_leaves = len(jax.tree_util.tree_leaves(world["params"]))
    assert len(sd) == n_leaves


def test_converter_rejects_a_stray_or_missing_leaf(world):
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in world["params"]["params"].items()}
    stray = dict(params, stray_layer={"kernel": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="stray_layer"):
        inferer_from_flax(stray, tinf.InfererConfig(**CFG), world["smplx"].num_vertices, "cpu")
    missing = {k: v for k, v in params.items() if k != "global_map1"}
    with pytest.raises(ValueError, match="global_map1"):
        inferer_from_flax(missing, tinf.InfererConfig(**CFG), world["smplx"].num_vertices, "cpu")


@pytest.fixture(scope="module")
def module_outputs(world):
    """The bare module at B = 2 on a random texel mask."""
    rng = np.random.default_rng(1)
    smplx = world["smplx"]
    src = _source(rng, 2, smplx.n_shape, smplx.n_exp)
    with torch.no_grad():
        verts = ehm_forward(
            world["tehm"],
            BodyParams(shape=torch.tensor(src["shape"]), body_pose=torch.tensor(src["body_pose"])),
            FlameParams(shape=torch.zeros(2, smplx.n_shape), exp=torch.tensor(src["flame_exp"]),
                        jaw=torch.zeros(2, 3))).vertices.numpy()
    f_idx, f_bary, mask = world["tables"]
    texel_mask = (rng.uniform(size=(2, 16, 16)) < 0.7).astype(np.float32) * mask[None]
    want = jax.jit(world["jmod"].apply)(
        world["params"], jnp.asarray(src["image"]), jnp.asarray(src["w2c"]), jnp.asarray(verts),
        jnp.asarray(texel_mask), jnp.asarray(f_idx), jnp.asarray(f_bary),
        jnp.asarray(world["faces"]))
    with torch.no_grad():
        got = world["tmod"](
            torch.tensor(src["image"]), torch.tensor(src["w2c"]), torch.tensor(verts),
            torch.tensor(texel_mask), torch.tensor(f_idx), torch.tensor(f_bary),
            torch.tensor(world["faces"]))
    return got, want


def _close(got, want, field):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, field
    assert np.isfinite(g).all(), field
    if field.endswith("scales") and "uv" in field:
        np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0, err_msg=field)
    else:
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=field)


@pytest.mark.parametrize("field", GS_FIELDS)
def test_module_vertex_branch_vs_flax(module_outputs, field):
    got, want = module_outputs
    _close(got[0][field], want[0][field], "vtx_" + field)


@pytest.mark.parametrize("field", GS_FIELDS + ("local_pos",))
def test_module_uv_branch_vs_flax(module_outputs, field):
    got, want = module_outputs
    assert got[1][field].shape[:2] == (2, 256)
    _close(got[1][field], want[1][field], "uv_" + field)


def test_module_uvmap_texture_vs_flax(module_outputs):
    got, want = module_outputs
    _close(got[2]["uvmap_texture"], want[2]["uvmap_texture"], "uvmap_texture")


@pytest.fixture(scope="module")
def avatars(world):
    cache = {}

    def get(B):
        if B not in cache:
            rng = np.random.default_rng(10 + B)
            smplx = world["smplx"]
            src = _source(rng, B, smplx.n_shape, smplx.n_exp)
            f_idx, f_bary, mask = world["tables"]

            @jax.jit
            def jbuild(params, image, w2c, shape, body_pose, flame_exp):
                jbody = JBody(shape=shape, body_pose=body_pose)
                jflame = JFlame(shape=jnp.zeros((B, smplx.n_shape)), exp=flame_exp,
                                jaw=jnp.zeros((B, 3)))
                avatar, extra = jinf.build_avatar(
                    world["jmod"], params, world["jehm"], jnp.asarray(world["faces"]),
                    jnp.asarray(f_idx), jnp.asarray(f_bary), jnp.asarray(mask), image, w2c,
                    jbody, jflame, image_size=32, invtanfov=3.0)
                return avatar, {"ehm_result": extra["ehm_result"]}

            want, wextra = jbuild(world["params"], *(jnp.asarray(src[k]) for k in (
                "image", "w2c", "shape", "body_pose", "flame_exp")))
            body = BodyParams(shape=torch.tensor(src["shape"]),
                              body_pose=torch.tensor(src["body_pose"]))
            flame = FlameParams(shape=torch.zeros(B, smplx.n_shape),
                                exp=torch.tensor(src["flame_exp"]), jaw=torch.zeros(B, 3))
            with torch.no_grad():
                got, gextra = tinf.build_avatar(
                    world["tmod"], world["tehm"], torch.tensor(world["faces"]),
                    torch.tensor(f_idx), torch.tensor(f_bary), torch.tensor(mask),
                    torch.tensor(src["image"]), torch.tensor(src["w2c"]), body, flame,
                    image_size=32, invtanfov=3.0)
            cache[B] = (got, want, gextra, wextra)
        return cache[B]

    return get


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("field", tinf.GaussianAvatar._fields)
def test_build_avatar_vs_jax(avatars, B, field):
    got, want, _, _ = avatars(B)
    g, w = getattr(got, field), np.asarray(getattr(want, field))
    if field in ("uv_binding_face", "uv_valid"):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    else:
        _close(g, w, field)


@pytest.mark.parametrize("B", [1, 2])
def test_build_avatar_visibility(avatars, world, B):
    """The texel mask is chart mask x visibility of the texel's face; some
    faces are visible and some hidden (the back of the body)."""
    got, _, gextra, wextra = avatars(B)
    visible = gextra["visible_faces"]
    assert visible.shape == (B, world["faces"].shape[0])
    assert 0 < int(visible[0].sum()) < visible.shape[1]
    f_idx, _, mask = world["tables"]
    want_mask = visible[:, torch.tensor(f_idx)] & torch.tensor(mask)[None]
    np.testing.assert_array_equal(gextra["texel_mask"].numpy(), want_mask.float().numpy())
    assert float(gextra["texel_mask"][:, ~mask].abs().max()) == 0.0
    np.testing.assert_allclose(gextra["ehm_result"].vertices.numpy(),
                               np.asarray(wextra["ehm_result"].vertices), atol=1e-5)
    # vtx_positions is the rest template, not the posed vertices
    np.testing.assert_array_equal(got.vtx_positions[0].numpy(),
                                  world["tehm"].smplx["v_template"].numpy())
