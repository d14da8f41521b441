"""The config-driven runtime (`guava_renderer_tpu_torch/cli/context.py`)
against the JAX package's `cli/context.py`, and the slice as a whole: a
frame of `FramePipeline.from_runtime` against the JAX `FramePipeline`.

Both runtimes are built with synthetic assets from the same config. Their
InfererConfig, refiner options, kept raster knobs and LossConfig are equal.
On micro_synthetic.yaml the JAX runtime's `init_params` is carried into the
port's modules by convert.py; the port's frame of the avatar it creates then
agrees with the JAX frame of that avatar within atol 1e-4 (render, raw,
invdepth), as tests/test_torch_frame.py holds frames. The port bins uncapped; the micro raster block caps a Gaussian
at 4 tiles of a 2 x 2 grid, so the JAX frame truncates nothing, which the
test asserts by its own count before comparing.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar.deformer import deform_avatar as jdeform_avatar
from guava_renderer_tpu.avatar.renderer import NeuralRefiner as JNeuralRefiner
from guava_renderer_tpu.avatar.state import GaussianAvatar as JAvatar
from guava_renderer_tpu.cli import context as jctx
from guava_renderer_tpu.cli.inference import FramePipeline as JFramePipeline
from guava_renderer_tpu.cli.inference import _batched_params as jbatched
from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops.gsplat import ALPHA_MIN
from guava_renderer_tpu.ops.gsplat import bin_gaussians as jbin_gaussians
from guava_renderer_tpu.ops.gsplat_project import project_gaussians as jproject
from guava_renderer_tpu.train.pipeline import _unpack_params as junpack
from guava_renderer_tpu.utils.config import load_config as jload_config
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.cli.inference import FramePipeline
from guava_renderer_tpu_torch.convert import model_from_flax
from guava_renderer_tpu_torch.train.checkpoints import CheckpointManager
from guava_renderer_tpu_torch.train.trainstep import make_train_state
from guava_renderer_tpu_torch.testing import write_schema_assets
from guava_renderer_tpu_torch.train.weights import save_converted_params
from guava_renderer_tpu_torch.utils.config import load_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
TINY = str(ROOT / "configs" / "train" / "tiny_synthetic.yaml")
ATOL = 1e-4


def _jax_runtime(path, overrides=None):
    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        return jctx.build_runtime(jload_config(path, overrides), synthetic_assets=True)
    finally:
        mp.undo()


def _port_runtime(path, overrides=None):
    return tctx.build_runtime(load_config(path, overrides), synthetic_assets=True, device="cpu")


def _renderer_options(jr):
    return dict(refiner_type=jr.refiner_type, small=jr.small, style_dim=jr.style_dim,
                num_mlp=jr.num_mlp, channel_scale=jr.channel_scale,
                refiner_size=jr.refiner_size or jr.image_size,
                bf16=jr.refiner_dtype is not None)


def _port_renderer_options(tr):
    nr = tr.neural_refiner
    su = nr.refiner
    return dict(refiner_type=nr.refiner_type,
                small=getattr(getattr(su, "generator", None), "small", True),
                style_dim=su.final_linear.out_features if hasattr(su, "final_linear") else 512,
                num_mlp=su.generator.style_mlp.num_mlp if hasattr(su, "generator") else 8,
                channel_scale=256 / su.final_conv.out_channels,
                refiner_size=tr.refiner_size, bf16=tr.refiner_dtype == torch.bfloat16)


@pytest.mark.parametrize("path,overrides", [
    (MICRO, None), (TINY, None),
    (MICRO, {"MODEL": {"bf16_refiner": True}}),
    (MICRO, {"MODEL": {"refiner_type": "simpleunet"}}),
    (MICRO, {"MODEL": {"image_size": 48, "styleunet": {"small": False}}}),
    (TINY, {"MODEL": {"raster": {"vmem_classes": 1, "size_classes": [[8, 4], [16, 2]],
                                 "streaming": False, "bf16_rows": False, "tile": 8}}}),
], ids=["micro", "tiny", "micro-bf16", "micro-simpleunet", "micro-48-not-small", "tiny-vmem"])
def test_build_runtime_equals_jax(path, overrides):
    jrt, trt = _jax_runtime(path, overrides), _port_runtime(path, overrides)
    assert trt.inferer.cfg._asdict() == jrt.inferer.cfg._asdict()
    assert _port_renderer_options(trt.renderer) == _renderer_options(jrt.renderer)
    js = jrt.renderer.settings
    kept = ("tile", "bf16_rows", "size_classes", "vmem_classes", "streaming")
    assert {k: getattr(trt.renderer.settings, k) for k in kept} == \
        {k: getattr(js, k) for k in kept}
    raster = jload_config(path, overrides).MODEL.raster.to_dict()
    assert trt.ignored_raster == {k: v for k, v in raster.items() if k not in kept}
    assert trt.statics.loss_cfg._asdict() == jrt.statics.loss_cfg._asdict()
    assert (trt.statics.image_size, trt.statics.invtanfov) == \
        (jrt.statics.image_size, jrt.statics.invtanfov)
    assert trt.num_vertices == jrt.num_vertices
    for name in ("faces", "uvmap_f_idx", "uvmap_f_bary", "uvmap_mask"):
        np.testing.assert_array_equal(getattr(trt.statics, name).numpy(),
                                      np.asarray(getattr(jrt.statics, name)), err_msg=name)
    for k, v in jrt.ehm.smplx.items():
        np.testing.assert_allclose(trt.ehm.smplx[k].numpy(), np.asarray(v), atol=1e-6,
                                   err_msg=k)


def test_unknown_refiner_type_raises_as_jax():
    over = {"MODEL": {"refiner_type": "unet3"}}
    with pytest.raises(ValueError, match="unknown refiner_type"):
        _port_runtime(MICRO, over)
    with pytest.raises(ValueError, match="unknown refiner_type"):
        JNeuralRefiner(refiner_type="unet3").init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 32)))


def test_refused_raster_settings():
    with pytest.raises(ValueError, match="vmem_classes requires size_classes"):
        _port_runtime(MICRO, {"MODEL": {"raster": {"vmem_classes": 1}}})
    with pytest.raises(ValueError, match="bf16_rows covers the default"):
        _port_runtime(MICRO, {"MODEL": {"raster": {"streaming": True, "bf16_rows": True}}})


def test_ignored_raster_reported(capsys):
    rt = _port_runtime(MICRO)
    assert rt.ignored_raster == {"chunk": 8, "max_tiles_per_gaussian": 4}
    err = capsys.readouterr().err
    assert err.count("ignored by the port") == 1 and "'chunk': 8" in err


def test_synthetic_fallback_notice(capsys, tmp_path):
    """Absent asset files: JAX's notice, then the synthetic rig."""
    cfg = load_config(MICRO, {"MODEL": {"smplx_assets_dir": str(tmp_path / "none")}})
    tctx.build_runtime(cfg, synthetic_assets=False, device="cpu")
    out = capsys.readouterr().out
    assert "SMPL-X model files not found — falling back to synthetic assets" in out
    assert str(tmp_path / "none" / "SMPLX_NEUTRAL_2020.npz") in out
    tctx.build_runtime(cfg, synthetic_assets=True, device="cpu")
    assert "falling back" not in capsys.readouterr().out


# ---- the real-asset branch, on reduced-count schema files ----

REAL_COUNTS = {"smplx_vertices": 6223, "smplx_faces": 12376}


@pytest.fixture(scope="module")
def real_assets(tmp_path_factory):
    paths = write_schema_assets(str(tmp_path_factory.mktemp("schema")), seed=1,
                                counts=REAL_COUNTS)
    return {"MODEL": {"smplx_assets_dir": paths["smplx_dir"],
                      "flame_assets_dir": paths["flame_dir"]}}


def _assert_same_ehm(tehm, jehm):
    """Every EHM table equal, but the grafted SMPL-X template: the FLAME head
    moved to the eye anchor, which each package regresses in its own float32
    einsum (atol 1e-6, as test_build_runtime_equals_jax holds it)."""
    for part in ("smplx", "flame"):
        jpart, tpart = getattr(jehm, part), getattr(tehm, part)
        assert sorted(tpart) == sorted(jpart)
        for k, v in jpart.items():
            if (part, k) == ("smplx", "v_template"):
                np.testing.assert_allclose(tpart[k].numpy(), np.asarray(v), atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(tpart[k].numpy(), np.asarray(v),
                                              err_msg=f"{part}.{k}")


def _with(over, **model):
    return {"MODEL": dict(over["MODEL"], **model)}


@pytest.fixture(scope="module")
def real_frames(real_assets):
    """Both packages' build_runtime on the files at micro widths (without the
    teeth, which the JAX real branch cannot graft: see the next test); the
    port creates the avatar and both render it, as micro_frames does."""
    over = _with(real_assets, add_teeth=False)
    jrt = jctx.build_runtime(jload_config(MICRO, over))
    trt = tctx.build_runtime(load_config(MICRO, over), device="cpu")
    with jax.default_prng_impl("unsafe_rbg"):
        params = jax.jit(lambda: jctx.init_params(jrt, seed=0))()
    model_from_flax(jax.tree_util.tree_map(np.asarray, params["model"]),
                    trt.inferer, trt.renderer)
    source, target = _source_and_target(trt.smplx.n_shape, trt.smplx.n_exp)
    tpipe = FramePipeline.from_runtime(trt)
    tavatar, _ = tpipe.infer_avatar(source)
    tout = tpipe.render_frame(tavatar, target)
    javatar = JAvatar(**{k: jnp.asarray(getattr(tavatar, k).numpy())
                         for k in JAvatar._fields})
    jout = {k: np.asarray(v)
            for k, v in JFramePipeline(jrt, params["model"]).render_frame(javatar, target).items()}
    truncated = int(jax.jit(lambda a: _num_truncated(jrt, a, target))(javatar))
    return dict(jrt=jrt, trt=trt, tout=tout, jout=jout, truncated=truncated)


def test_real_assets_runtime_equals_jax(real_frames):
    """The loaders, the EHM and the statics of both real branches; then the
    created-and-rendered frame within ATOL of the JAX frame."""
    jrt, trt = real_frames["jrt"], real_frames["trt"]
    assert (trt.smplx.n_shape, trt.smplx.n_exp) == (jrt.smplx.n_shape, jrt.smplx.n_exp) == \
        (300, 50)
    assert trt.num_vertices == jrt.num_vertices == REAL_COUNTS["smplx_vertices"]
    for name in ("faces", "uvmap_f_idx", "uvmap_f_bary", "uvmap_mask"):
        np.testing.assert_array_equal(getattr(trt.statics, name).numpy(),
                                      np.asarray(getattr(jrt.statics, name)), err_msg=name)
    _assert_same_ehm(trt.ehm, jrt.ehm)
    for k in ("smplx2flame_ind", "left_hand_ind", "right_hand_ind", "left_hand_center",
              "right_hand_center"):
        np.testing.assert_array_equal(getattr(trt.ehm, k).numpy(), np.asarray(getattr(jrt.ehm, k)),
                                      err_msg=k)
    assert (trt.ehm.smplx_parents, trt.ehm.flame_parents) == \
        (jrt.ehm.smplx_parents, jrt.ehm.flame_parents)
    assert real_frames["truncated"] == 0
    for key in ("render", "raw", "invdepth"):
        got, want = real_frames["tout"][key].numpy(), real_frames["jout"][key]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=key)
    assert float(real_frames["jout"]["raw"].max()) > 0.0, "the frame is background"


def test_real_assets_runtime_grafts_flame_teeth(real_assets):
    """With add_teeth (ubody_512's setting) the port grafts the FLAME teeth
    rows that the SMPL-X graft's id map points at; the JAX real branch does
    not and fails in EhmModel.build. The port's EHM equals the JAX EHM built
    from the JAX loaders with that graft."""
    from guava_renderer_tpu.bodymodel import data as jdata
    from guava_renderer_tpu.bodymodel.ehm import EhmModel as JEhmModel
    from guava_renderer_tpu.bodymodel.flame import add_teeth_flame as jadd_teeth_flame

    over = _with(real_assets, add_teeth=True)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jctx.build_runtime(jload_config(MICRO, over))
    trt = tctx.build_runtime(load_config(MICRO, over), device="cpu")
    m = over["MODEL"]
    jsmplx, jextras = jdata.load_smplx(m["smplx_assets_dir"], add_teeth=True, uv_size=16,
                                       flame_assets_dir=m["flame_assets_dir"])
    jflame, _ = jadd_teeth_flame(jdata.load_flame(m["flame_assets_dir"]))
    jehm = JEhmModel.build(jsmplx, jflame, jextras)
    assert trt.flame.num_vertices == 5023 + 120      # FLAME 2020 plus the 8 x 15 teeth rows
    _assert_same_ehm(trt.ehm, jehm)
    tctx.init_params(trt, seed=0)
    source, target = _source_and_target(trt.smplx.n_shape, trt.smplx.n_exp)
    pipe = FramePipeline.from_runtime(trt)
    avatar, _ = pipe.infer_avatar(source)
    out = pipe.render_frame(avatar, target)
    assert out["render"].shape == (32, 32, 3) and bool(torch.isfinite(out["render"]).all())


def test_real_assets_missing_file_is_named(real_assets, tmp_path):
    import shutil

    smplx_dir = tmp_path / "SMPLX"
    shutil.copytree(real_assets["MODEL"]["smplx_assets_dir"], smplx_dir)
    (smplx_dir / "MANO_SMPLX_vertex_ids.pkl").unlink()
    cfg = load_config(MICRO, _with(real_assets, smplx_assets_dir=str(smplx_dir)))
    with pytest.raises(FileNotFoundError, match="MANO_SMPLX_vertex_ids.pkl"):
        tctx.build_runtime(cfg, device="cpu")


def test_build_runtime_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tctx.build_runtime(load_config(MICRO), synthetic_assets=True)


def test_resolve_config(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert tctx.resolve_config("micro_synthetic").to_dict() == load_config(MICRO).to_dict()
    assert tctx.resolve_config(MICRO).MODEL.image_size == 32
    load_config(TINY)._dump(str(tmp_path / "config.yaml"))
    assert tctx.resolve_config(str(tmp_path)).MODEL.image_size == 64
    with pytest.raises(FileNotFoundError):
        tctx.resolve_config(str(tmp_path / "nope"))


# ---- the slice as a whole on micro_synthetic.yaml ----

def _source_and_target(n_shape, n_exp):
    rng = np.random.default_rng(0)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 6.0
    zero = {"shape": np.zeros(n_shape, np.float32), "body_pose": np.zeros((21, 3), np.float32),
            "flame_shape": np.zeros(n_shape, np.float32),
            "flame_exp": np.zeros(n_exp, np.float32), "flame_jaw": np.zeros(3, np.float32)}
    source = {"image": rng.uniform(0, 1, (28, 28, 3)).astype(np.float32), "w2c": w2c,
              "params": zero}
    target = {"params": dict(zero, body_pose=np.full((21, 3), 0.03, np.float32),
                             flame_exp=np.full(n_exp, 0.2, np.float32),
                             flame_jaw=np.array([0.1, 0.0, 0.0], np.float32)), "w2c": w2c}
    return source, target


def _num_truncated(jrt, avatar, target):
    """Tile instances the JAX frame's caps drop (0 = the uncapped instance set)."""
    body, flame = junpack(jbatched(target["params"]))
    gs = jdeform_avatar(avatar, jrt.ehm, jrt.statics.faces, body, flame)
    size = jrt.cfg.MODEL.image_size
    tanfov = jnp.asarray(1.0 / jrt.cfg.MODEL.invtanfov, jnp.float32)
    w2c = jnp.asarray(target["w2c"])
    cam = JCamera(R=w2c[:3, :3], t=w2c[:3, 3], tanfovx=tanfov, tanfovy=tanfov,
                  width=size, height=size)
    st = jrt.renderer.settings
    proj = jproject(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], cam,
                    st.scale_modifier, st.antialiasing)
    contributing = proj.valid & (proj.alpha.reshape(-1) >= ALPHA_MIN)
    *_, num_truncated = jbin_gaussians(proj.mean2d, proj.depth, proj.radius_bin, contributing,
                                       size, size, st, conic=proj.conic, alpha=proj.alpha)
    return num_truncated


@pytest.fixture(scope="module")
def micro_frames():
    """The port creates the avatar (`from_runtime` -> infer_avatar: creation,
    prune, face-sort plan) and renders the target; the JAX `FramePipeline`
    renders the same avatar (creation itself is held against JAX by
    tests/test_torch_create.py)."""
    jrt = _jax_runtime(MICRO)
    # JAX's rbg generator compiles the init in ~25 s where threefry takes ~35
    with jax.default_prng_impl("unsafe_rbg"):
        params = jax.jit(lambda: jctx.init_params(jrt, seed=0))()
    trt = _port_runtime(MICRO)
    model_from_flax(jax.tree_util.tree_map(np.asarray, params["model"]),
                    trt.inferer, trt.renderer)
    source, target = _source_and_target(trt.smplx.n_shape, trt.smplx.n_exp)
    tpipe = FramePipeline.from_runtime(trt)
    tavatar, _ = tpipe.infer_avatar(source)
    tout = tpipe.render_frame(tavatar, target)

    javatar = JAvatar(**{k: jnp.asarray(getattr(tavatar, k).numpy())
                         for k in JAvatar._fields})
    jpipe = JFramePipeline(jrt, params["model"])
    jout = {k: np.asarray(v) for k, v in jpipe.render_frame(javatar, target).items()}
    truncated = int(jax.jit(lambda a: _num_truncated(jrt, a, target))(javatar))
    return dict(trt=trt, tavatar=tavatar, jout=jout, tout=tout, tpipe=tpipe, target=target,
                truncated=truncated)


def test_micro_frame_truncates_nothing_in_jax(micro_frames):
    assert micro_frames["truncated"] == 0


def test_from_runtime_pipeline(micro_frames):
    pipe, trt = micro_frames["tpipe"], micro_frames["trt"]
    assert (pipe.image_size, pipe.invtanfov, pipe.opacity_threshold) == (32, 3.0, 0.001)
    assert pipe.renderer.settings == trt.renderer.settings
    assert pipe.renderer.neural_refiner is trt.renderer.neural_refiner
    assert pipe.plan is not None, "the pruned micro avatar takes the planned gather"
    assert pipe.tanfov == 1.0 / 3.0


@pytest.mark.parametrize("key", ["render", "raw", "invdepth"])
def test_micro_frame_vs_jax(micro_frames, key):
    got, want = micro_frames["tout"][key].numpy(), micro_frames["jout"][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if key == "raw":
        assert float(want.max()) > 0.0, "the frame is background"


def test_render_frames_takes_the_options(micro_frames):
    pipe, target = micro_frames["tpipe"], micro_frames["target"]
    avatar = micro_frames["tavatar"]
    grouped = pipe.render_frames(avatar, [target, target], group=2)
    for out in grouped:
        torch.testing.assert_close(out["render"], micro_frames["tout"]["render"], rtol=0,
                                   atol=0)


# ---- weight discovery ----

def test_load_model_params_order(tmp_path, capsys):
    rt = _port_runtime(MICRO)
    tctx.init_params(rt, seed=3)
    trained = {k: v + 0.5 for k, v in rt.model.state_dict().items()}
    rt.model.load_state_dict(trained)
    cm = CheckpointManager(str(tmp_path / "run"))
    cm.save_latest(make_train_state(rt.model), 7)

    def loaded(model):
        return all(torch.equal(model.state_dict()[k], v) for k, v in trained.items())

    rt2 = _port_runtime(MICRO)
    model, desc = tctx.load_model_params(rt2, str(tmp_path / "run"))
    assert desc.endswith("latest.pt @ iter 7") and loaded(model)
    rt3 = _port_runtime(MICRO)
    model, desc = tctx.load_model_params(rt3, None, basemodel=cm.find_checkpoint())
    assert desc.endswith("@ iter 7") and loaded(model)

    save_converted_params(str(tmp_path / "converted_params.pt"), trained)
    rt4 = _port_runtime(MICRO)
    model, desc = tctx.load_model_params(rt4, str(tmp_path))
    assert desc.startswith("converted reference weights") and loaded(model)

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no trained weights found"):
        tctx.load_model_params(_port_runtime(MICRO), str(empty))
    model, desc = tctx.load_model_params(_port_runtime(MICRO), str(empty), allow_random=True)
    assert desc == "random initialization"
    assert "RANDOM WEIGHTS" in capsys.readouterr().out


def test_converted_params_are_checked(tmp_path):
    rt = _port_runtime(MICRO)
    sd = dict(rt.model.state_dict())
    sd.pop(next(iter(sd)))
    save_converted_params(str(tmp_path / "converted_params.pt"), sd)
    with pytest.raises(ValueError, match="missing keys"):
        tctx.load_model_params(rt, str(tmp_path))


def test_pretrained_backbones(tmp_path, capsys):
    rt = _port_runtime(MICRO, {"MODEL": {"pretrained_dir": str(tmp_path)}})
    tctx.init_params(rt, seed=1)
    assert "no pretrained DINOv2" in capsys.readouterr().out
    dino = {k: torch.full_like(v, 0.25) for k, v in
            rt.inferer.dino_encoder.dino.state_dict().items()}
    lp = {k: torch.full_like(v, 0.5) for k, v in rt.lpips.state_dict().items()}
    save_converted_params(str(tmp_path / "dinov2_vitb14.pt"), dino)
    save_converted_params(str(tmp_path / "lpips_alex.pt"), lp)
    tctx.init_params(rt, seed=1)
    out = capsys.readouterr().out
    assert "loaded pretrained DINOv2" in out and "loaded pretrained LPIPS" in out
    assert all(torch.equal(rt.inferer.dino_encoder.dino.state_dict()[k], v)
               for k, v in dino.items())
    assert all(torch.equal(rt.lpips.state_dict()[k], v) for k, v in lp.items())


def test_init_params_is_seeded():
    a, b = _port_runtime(MICRO), _port_runtime(MICRO)
    tctx.init_params(a, seed=5)
    tctx.init_params(b, seed=5)
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert all(torch.isfinite(p).all() for p in a.model.parameters())


def test_camera_and_params_helpers():
    rt = _port_runtime(MICRO)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = (0.1, 0.2, 6.0)
    cam = tctx.camera_from_w2c(rt, w2c)
    jcam = jctx.camera_from_w2c(_jax_runtime(MICRO), w2c)
    np.testing.assert_array_equal(cam.t.numpy(), np.asarray(jcam.t))
    np.testing.assert_allclose(float(cam.tanfovx), float(jcam.tanfovx))
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    p = {"shape": torch.zeros(1, 8), "body_pose": torch.zeros(1, 21, 3),
         "flame_shape": torch.zeros(1, 8), "flame_exp": torch.zeros(1, 4),
         "flame_jaw": torch.zeros(1, 3)}
    body, flame = tctx.batch_params_to_body_flame(p)
    assert body.shape is p["shape"] and flame.jaw is p["flame_jaw"]
