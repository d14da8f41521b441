"""Avatar creation as a whole: the port's `FramePipeline.infer_avatar`
-> `render_frame` against the JAX package's `build_avatar` ->
`prune_avatar` -> deform -> rasterize -> refiner, at the widths of
`testing.make_micro_pipeline` (28^2 source, 32^2 frames, 16^2 chart).

The JAX frame rasterizes with presort and a duplication cap of the whole
tile grid, so nothing is truncated (Pallas in interpret mode). atol 1e-4
on the avatar's bounded fields and on render, raw and invdepth; the UV
scales relatively, rtol 1e-3.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar import inferer as jinf
from guava_renderer_tpu.avatar.deformer import deform_avatar
from guava_renderer_tpu.avatar.renderer import NeuralRefiner as JRefiner
from guava_renderer_tpu.avatar.state import prune_avatar
from guava_renderer_tpu.bodymodel import synthetic_ehm as jsynthetic_ehm
from guava_renderer_tpu.bodymodel.ehm import BodyParams as JBody
from guava_renderer_tpu.bodymodel.ehm import EhmModel as JEhm
from guava_renderer_tpu.bodymodel.ehm import FlameParams as JFlame
from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops.gsplat import RasterizeSettings as JSettings
from guava_renderer_tpu.ops.gsplat import rasterize
from guava_renderer_tpu_torch.avatar import inferer as tinf
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner as TRefiner
from guava_renderer_tpu_torch.benchscene import make_create_scene
from guava_renderer_tpu_torch.cli.inference import FramePipeline
from guava_renderer_tpu_torch.convert import inferer_from_flax, refiner_state_dict_from_flax
from guava_renderer_tpu_torch.kernels import meshraster as k5
from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings

torch.set_num_threads(2)
SIZE, UV, FEAT, TILE, INVTANFOV = 32, 16, 28, 16, 3.0
RIG = dict(body_side=12, head_side=6)
CFG = dict(image_size=SIZE, uvmap_size=UV, invtanfov=INVTANFOV, dino_out_dim=4, uv_out_dim=8,
           smplx_fea_dim=8, prj_out_dim=8, global_vertex_dim=16, uv_base_dim=4, style_dim=32,
           num_mlp=2, channel_scale=16.0, vit_dim=64, vit_depth=5, vit_heads=4,
           pyramid_dims=(16, 16, 16, 16))
REFINER = dict(style_dim=32, num_mlp=2, channel_scale=16.0)
ATOL = 1e-4
SCALE_RTOL = 1e-3


def _target(n_shape, n_exp):
    return {
        "shape": np.zeros(n_shape, np.float32),
        "body_pose": np.full((21, 3), 0.03, np.float32),
        "flame_shape": np.zeros(n_shape, np.float32),
        "flame_exp": np.full(n_exp, 0.2, np.float32),
        "flame_jaw": np.array([0.1, 0.0, 0.0], np.float32),
    }


@pytest.fixture(scope="module")
def created():
    tsc = make_create_scene(SIZE, UV, feat_size=FEAT, device="cpu", **RIG)
    # the bench camera stands at z = 30 for a long lens; the micro lens is wide
    source = dict(tsc.source, w2c=np.array(tsc.source["w2c"]))
    source["w2c"][2, 3] = 6.0
    smplx = tsc.smplx
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "cv2", None)      # JAX onto its numpy UV rasterizer
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jrig = jsynthetic_ehm(uv_size=UV, n_shape=50, n_exp=20, **RIG)
    finally:
        mp.undo()
    jehm = JEhm.build(*jrig)
    f_idx, f_bary, mask = (jnp.asarray(np.asarray(t)) for t in
                           (jrig[2].uvmap_f_idx, jrig[2].uvmap_f_bary, jrig[2].uvmap_mask))
    faces = jnp.asarray(jrig[0].faces)
    V = smplx.num_vertices

    rng = np.random.default_rng(0)
    jmod = jinf.UbodyGaussianInferer(cfg=jinf.InfererConfig(**CFG), num_vertices=V)
    image = jnp.asarray(source["image"])[None]
    w2c = jnp.asarray(source["w2c"])[None]
    inf_params = jax.jit(jmod.init)(jax.random.PRNGKey(0), image, w2c, jnp.zeros((1, V, 3)),
                                    jnp.zeros((1, UV, UV)), f_idx, f_bary, faces)
    jref = JRefiner(image_size=SIZE, small=True, **REFINER)
    ref_params = jref.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 32)))
    inf_params, ref_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, np.shape(a)).astype(np.float32),
        (inf_params, ref_params))

    def jparams(p):
        body = JBody(shape=jnp.asarray(p["shape"])[None],
                     body_pose=jnp.asarray(p["body_pose"])[None])
        flame = JFlame(shape=jnp.asarray(p["flame_shape"])[None],
                       exp=jnp.asarray(p["flame_exp"])[None],
                       jaw=jnp.asarray(p["flame_jaw"])[None])
        return body, flame

    @jax.jit
    def jcreate(params, image, w2c):
        body, flame = jparams(source["params"])
        return jinf.build_avatar(jmod, params, jehm, faces, f_idx, f_bary, mask, image, w2c,
                                 body, flame, image_size=SIZE, invtanfov=INVTANFOV)[0]

    javatar_full = jcreate(inf_params, image, w2c)
    javatar = prune_avatar(javatar_full, 0.001)
    target = _target(smplx.n_shape, smplx.n_exp)
    tanfov = jnp.asarray(1.0 / INVTANFOV, jnp.float32)
    settings = JSettings(tile=TILE, max_tiles_per_gaussian=(SIZE // TILE) ** 2)

    @jax.jit
    def jframe(avatar, w2c):
        body, flame = jparams(target)
        gs = deform_avatar(avatar, jehm, faces, body, flame)
        cam = JCamera(R=w2c[:3, :3], t=w2c[:3, 3], tanfovx=tanfov, tanfovy=tanfov,
                      width=SIZE, height=SIZE)
        color, _, invd = rasterize(gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0],
                                   gs.rotation[0], cam, jnp.zeros(32), settings,
                                   channels_first=False)
        rgb = jref.apply(ref_params, color[None])[0]
        return jnp.clip(rgb, 0, 1), jnp.clip(color[..., :3], 0, 1), invd[..., 0]

    jout = dict(zip(("render", "raw", "invdepth"),
                    (np.asarray(a) for a in jframe(javatar, w2c[0]))))

    tref = TRefiner(image_size=SIZE, **REFINER)
    tref.load_state_dict(refiner_state_dict_from_flax(ref_params))
    inferer = inferer_from_flax(inf_params, tinf.InfererConfig(**CFG), V, device="cpu")
    pipe = FramePipeline(tsc.ehm, tsc.faces, tref, inferer=inferer, uv_tables=tsc.uv_tables,
                         image_size=SIZE, invtanfov=INVTANFOV,
                         settings=RasterizeSettings(tile=TILE), device="cpu")
    launches = k5.launches
    tavatar, extra = pipe.infer_avatar(source)
    plan = pipe.plan
    tout = pipe.render_frame(tavatar, {"params": target, "w2c": source["w2c"]})
    tavatar_full, _ = pipe.infer_avatar(source, prune=False)
    unplanned = pipe.plan is None
    tout_full = pipe.render_frame(tavatar_full, {"params": target, "w2c": source["w2c"]})
    assert k5.launches == launches, "the CPU path must not count kernel launches"
    return dict(javatar=javatar, javatar_full=javatar_full, jout=jout, tavatar=tavatar,
                tavatar_full=tavatar_full, tout=tout, tout_full=tout_full, extra=extra,
                plan=plan, unplanned=unplanned, pipe=pipe)


def _close(g, w, field):
    g, w = g.numpy(), np.asarray(w)
    assert g.shape == w.shape, field
    if field == "uv_scales":
        np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=1e-9, err_msg=field)
    elif field in ("uv_binding_face", "uv_valid"):
        np.testing.assert_array_equal(g, w, err_msg=field)
    else:
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=field)


@pytest.mark.parametrize("field", tinf.GaussianAvatar._fields)
def test_unpruned_avatar_vs_jax(created, field):
    _close(getattr(created["tavatar_full"], field), getattr(created["javatar_full"], field), field)


def test_pruned_avatar_vs_jax_prune(created):
    """`infer_avatar` prunes and pads as the JAX `prune_avatar` does, then
    face-sorts: the pruned set is the JAX one up to the plan's permutation."""
    assert created["plan"] is not None and created["unplanned"]
    got, want = created["tavatar"], created["javatar"]
    assert got.uv_local_xyz.shape == np.asarray(want.uv_local_xyz).shape
    inv = torch.as_tensor(created["plan"].inv_perm, dtype=torch.int64)
    for field in ("uv_local_xyz", "uv_colors", "uv_opacity", "uv_scales", "uv_rotations"):
        _close(getattr(got, field)[:, inv], getattr(want, field), field)
    np.testing.assert_array_equal(got.uv_valid[inv].numpy(), np.asarray(want.uv_valid))
    np.testing.assert_array_equal(got.uv_binding_face[inv].numpy(),
                                  np.asarray(want.uv_binding_face))


@pytest.mark.parametrize("key", ["render", "raw", "invdepth"])
def test_created_frame_vs_jax(created, key):
    got = created["tout"][key].numpy()
    assert got.shape == created["jout"][key].shape
    np.testing.assert_allclose(got, created["jout"][key], atol=ATOL, rtol=0)


@pytest.mark.parametrize("key", ["render", "raw", "invdepth"])
def test_unpruned_frame_equals_pruned_frame(created, key):
    """Pruning drops only what cannot be seen (off-chart and near-zero
    opacity rows), so the row-gather frame of the unpruned avatar agrees."""
    np.testing.assert_allclose(created["tout_full"][key].numpy(), created["tout"][key].numpy(),
                               atol=ATOL, rtol=0)


def test_created_frame_is_not_background(created):
    assert float(created["tout"]["raw"].max()) > 0.0
    assert float((created["tout"]["invdepth"] > 0).float().mean()) > 0.02
    vis = created["extra"]["visible_faces"]
    assert 0 < int(vis.sum()) < vis.numel()


def test_infer_avatar_needs_an_inferer(created):
    pipe = created["pipe"]
    bare = FramePipeline(pipe.ehm, pipe.faces, pipe.renderer.neural_refiner, image_size=SIZE,
                         invtanfov=INVTANFOV, device="cpu")
    with pytest.raises(RuntimeError, match="inferer"):
        bare.infer_avatar({})
    with pytest.raises(ValueError, match="UV tables"):
        FramePipeline(pipe.ehm, pipe.faces, pipe.renderer.neural_refiner, inferer=pipe.inferer,
                      device="cpu")
