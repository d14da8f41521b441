"""The slice as a whole: the port's FramePipeline vs the JAX frame on a
down-scaled bench scene (pruned, face-sorted, two poses).

JAX frame: ehm_forward -> deform_with_vertices(plan) -> rasterize (presort,
duplication cap = whole tile grid, so nothing is truncated; Pallas in
interpret mode) -> NeuralRefiner. atol 1e-4 on render, raw and invdepth:
the deformation's float error passes through projection into the blend.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu import benchscene as jbench
from guava_renderer_tpu.avatar.deformer import deform_with_vertices, sort_avatar_by_plan
from guava_renderer_tpu.avatar.renderer import NeuralRefiner as JRefiner
from guava_renderer_tpu.avatar.state import prune_avatar
from guava_renderer_tpu.bodymodel.ehm import BodyParams, FlameParams, ehm_forward
from guava_renderer_tpu.core.cameras import Camera
from guava_renderer_tpu.ops import facegather as jfg
from guava_renderer_tpu.ops.gsplat import RasterizeSettings as JSettings
from guava_renderer_tpu.ops.gsplat import rasterize
from guava_renderer_tpu_torch import benchscene as tbench
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner as TRefiner
from guava_renderer_tpu_torch.avatar.state import prune_avatar as tprune_avatar
from guava_renderer_tpu_torch.cli.inference import FramePipeline
from guava_renderer_tpu_torch.convert import refiner_state_dict_from_flax
from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings

torch.set_num_threads(2)
SCENE = dict(size=64, uv=64, body_side=21, head_side=7)
TILE = 16
REFINER = dict(style_dim=64, num_mlp=2, channel_scale=4.0)
ATOL = 1e-4


@pytest.fixture(scope="module")
def scenes():
    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jsc = jbench.make_bench_scene(**SCENE)
    finally:
        mp.undo()
    return jsc, tbench.make_bench_scene(**SCENE, device="cpu")


def test_bench_scene_arrays_equal(scenes):
    jsc, tsc = scenes
    for name in jsc.avatar._fields:
        np.testing.assert_array_equal(getattr(tsc.avatar, name).numpy(),
                                      np.asarray(getattr(jsc.avatar, name)), err_msg=name)
    np.testing.assert_array_equal(tsc.faces.numpy(), np.asarray(jsc.faces))
    for k, v in jsc.ehm.smplx.items():
        np.testing.assert_allclose(tsc.ehm.smplx[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tsc.cam.R.numpy(), np.asarray(jsc.cam.R))
    np.testing.assert_array_equal(tsc.cam.t.numpy(), np.asarray(jsc.cam.t))


def test_prune_avatar_equal(scenes):
    jsc, tsc = scenes
    want = prune_avatar(jsc.avatar, 0.001)
    got = tprune_avatar(tsc.avatar, 0.001)
    assert got.uv_local_xyz.shape[1] % 4096 == 0
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_frame0_gaussians_vs_jax(scenes):
    jsc, tsc = scenes
    want = jbench.frame0_gaussians(jsc)
    got = tbench.frame0_gaussians(tsc)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


def _targets(sc):
    n_shape, n_exp = sc.smplx.n_shape, sc.smplx.n_exp
    out = []
    for i in (1, 3):
        params = {
            "shape": np.zeros(n_shape, np.float32),
            "body_pose": np.full((21, 3), 0.01 * i, np.float32),
            "flame_shape": np.zeros(n_shape, np.float32),
            "flame_exp": np.full(n_exp, 0.1 * i, np.float32),
            "flame_jaw": np.array([0.05 * i, 0.0, 0.0], np.float32),
        }
        out.append({"params": params, "w2c": sc.w2c})
    return out


def _jax_frames(jsc, params, targets, settings=None):
    avatar = prune_avatar(jsc.avatar, 0.001)
    plan = jfg.build_face_sort_plan(np.asarray(avatar.uv_binding_face), np.asarray(avatar.uv_valid))
    avatar = sort_avatar_by_plan(avatar, plan)
    cfaces = jnp.asarray(jfg.compact_faces(plan, np.asarray(jsc.faces)))
    if settings is None:
        settings = JSettings(tile=TILE, max_tiles_per_gaussian=(jsc.size // TILE) ** 2)
    refiner = JRefiner(image_size=jsc.size, small=True, **REFINER)
    tanfov = jnp.asarray(1.0 / jbench.INVTANFOV, jnp.float32)

    @jax.jit
    def frame(tp, w2c):
        body = BodyParams(shape=tp["shape"], body_pose=tp["body_pose"])
        flame = FlameParams(shape=tp["flame_shape"], exp=tp["flame_exp"], jaw=tp["flame_jaw"])
        res = ehm_forward(jsc.ehm, body, flame)
        gs = deform_with_vertices(avatar, res.vertices, res.vertex_transforms, jsc.faces,
                                  plan=plan, compact_faces=cfaces)
        cam = Camera(R=w2c[:3, :3], t=w2c[:3, 3], tanfovx=tanfov, tanfovy=tanfov,
                     width=jsc.size, height=jsc.size)
        color, _, invd = rasterize(gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0],
                                   gs.rotation[0], cam, jnp.zeros(32), settings,
                                   channels_first=False)
        rgb = refiner.apply(params, color[None])[0]
        return jnp.clip(rgb, 0, 1), jnp.clip(color[..., :3], 0, 1), invd[..., 0]

    outs = []
    for t in targets:
        tp = {k: jnp.asarray(v)[None] for k, v in t["params"].items()}
        outs.append([np.asarray(a) for a in frame(tp, jnp.asarray(t["w2c"]))])
    return outs, plan


def test_frame_pipeline_vs_jax_frame(scenes):
    jsc, tsc = scenes
    refiner = JRefiner(image_size=jsc.size, small=True, **REFINER)
    params = jax.jit(refiner.init)(jax.random.PRNGKey(0), jnp.zeros((1, jsc.size, jsc.size, 32)))
    targets = _targets(tsc)
    want, jplan = _jax_frames(jsc, params, targets)

    tref = TRefiner(image_size=tsc.size, **REFINER)
    tref.load_state_dict(refiner_state_dict_from_flax(params))
    pipe = FramePipeline(tsc.ehm, tsc.faces, tref, image_size=tsc.size,
                         invtanfov=tbench.INVTANFOV, settings=RasterizeSettings(tile=TILE),
                         device="cpu")
    avatar = pipe.prepare_avatar(tsc.avatar)
    assert pipe.plan is not None, "n_uv % 256 == 0 must take the planned path"
    np.testing.assert_array_equal(pipe.plan.compact_ids.numpy(), jplan.compact_ids)

    seq = [pipe.render_frame(avatar, t) for t in targets]
    grouped = pipe.render_frames(avatar, targets, group=2)
    for w, s, g in zip(want, seq, grouped):
        for k, wk in zip(("render", "raw", "invdepth"), w):
            np.testing.assert_array_equal(g[k].numpy(), s[k].numpy(), err_msg=k)
            np.testing.assert_allclose(s[k].numpy(), wk, atol=ATOL, rtol=0, err_msg=k)
    assert float(seq[0]["raw"].max()) > 0.0, "the frame must not be all background"
