"""The port's inference drivers (`guava_renderer_tpu_torch/cli/inference.py`:
render_set, render_cross_set, render_novel_views, change_id_info,
canonical_gaussians and the avatar PLY) against the JAX package's on
micro_synthetic.yaml and a micro dataset the test writes.

The JAX runtime's `init_params` is carried into the port's modules by
convert.py, once for the file. Each package creates its own avatar and
renders its own frames; their renders agree to 1e-4 (tests/test_torch_frame.py,
tests/test_torch_context.py), and truncating quantization can then flip one
level, so every PNG pair is held to at most 1 level, on at most
PNG_SHARE of its pixels. The JAX drivers each build a FramePipeline; the
test hands them one, so its two programs compile once for the file.
"""

import json
import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar.deformer import canonical_gaussians as jcanonical
from guava_renderer_tpu.avatar.state import GaussianAvatar as JAvatar
from guava_renderer_tpu.cli import context as jctx
from guava_renderer_tpu.cli import inference as jinf
from guava_renderer_tpu.data.tracked import TrackedVideoDataset as JDataset
from guava_renderer_tpu.utils.config import load_config as jload_config
from guava_renderer_tpu_torch.avatar.deformer import canonical_gaussians
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.cli import inference as tinf
from guava_renderer_tpu_torch.convert import model_from_flax
from guava_renderer_tpu_torch.data.codec import read_rgb
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.data.tracked import TrackedVideoDataset
from guava_renderer_tpu_torch.ops.facegather import build_face_sort_plan
from guava_renderer_tpu_torch.utils import logging_utils
from guava_renderer_tpu_torch.utils.config import load_config
from guava_renderer_tpu_torch.utils.ply import load_gaussian_ply
from guava_renderer_tpu_torch.utils.video import read_video

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
PNG_LEVELS = 1          # largest difference of a PNG pair, in levels
PNG_SHARE = 0.005       # largest share of a PNG pair's values that differ
PLY_ATOL = 1e-5
N_FRAMES = 4
N_CROSS = 2
N_VIEWS = 4


def _datasets(cfg, data, jax_side):
    kw = dict(image_size=cfg.MODEL.image_size, feature_img_size=cfg.MODEL.feature_img_size,
              origin_image_size=cfg.DATASET.origin_image_size)
    return (JDataset if jax_side else TrackedVideoDataset)(data, "test", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=N_FRAMES, image_size=48, n_shape=8,
                            n_exp=4)
    over = {"DATASET": {"data_path": data}}

    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jrt = jctx.build_runtime(jload_config(MICRO, over), synthetic_assets=True)
    finally:
        mp.undo()
    with jax.default_prng_impl("unsafe_rbg"):
        params = jax.jit(lambda: jctx.init_params(jrt, seed=0))()["model"]
    trt = tctx.build_runtime(load_config(MICRO, over), synthetic_assets=True, device="cpu")
    model_from_flax(jax.tree_util.tree_map(np.asarray, params), trt.inferer, trt.renderer)

    jpipe = jinf.FramePipeline(jrt, params)
    out = {"tmp": tmp, "jrt": jrt, "trt": trt, "jpipe": jpipe}
    cfg = trt.cfg
    jds, tds = _datasets(cfg, data, True), _datasets(cfg, data, False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jinf, "FramePipeline", lambda rt, p: jpipe)
    try:
        for side, rt, mod, ds, p in (("jax", jrt, jinf, jds, params),
                                     ("port", trt, tinf, tds, trt.model)):
            base = tmp / side
            out[side] = {
                "results": mod.render_set(rt, p, ds, str(base / "self")),
                "cross": mod.render_cross_set(rt, p, ds, ds, str(base / "cross"),
                                              max_frames=N_CROSS),
                "novel": mod.render_novel_views(rt, p, ds, str(base / "novel"),
                                                num_keyframes=N_VIEWS),
            }
    finally:
        mp.undo()
    out["source"] = tds[0]["source"]
    out["tds"] = tds
    return out


def _pngs(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*.png"))


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    n, shape = 0, None
    while True:
        ok, f = cap.read()
        if not ok:
            break
        n, shape = n + 1, f.shape
    cap.release()
    return n, shape


@pytest.mark.parametrize("kind", ["self", "cross", "novel"])
def test_pngs_equal_jax(runs, kind):
    jdir, tdir = runs["tmp"] / "jax" / kind, runs["tmp"] / "port" / kind
    names = _pngs(jdir)
    assert names and names == _pngs(tdir)
    want = {"self": 2 * N_FRAMES, "cross": N_CROSS, "novel": N_VIEWS}[kind]
    assert len(names) == want
    for name in names:
        j = read_rgb(str(jdir / name)).astype(int)
        t = read_rgb(str(tdir / name)).astype(int)
        assert j.shape == t.shape, name
        diff = np.abs(j - t)
        assert diff.max() <= PNG_LEVELS, (name, int(diff.max()))
        assert (diff > 0).mean() <= PNG_SHARE, (name, float((diff > 0).mean()))
    if kind == "self":
        assert any(read_rgb(str(tdir / n)).max() > 0 for n in names if "/render/" in n)


@pytest.mark.parametrize("kind,video", [("self", "vid000/vid000_compare.mp4"),
                                        ("cross", "cross_reenact.mp4"),
                                        ("novel", "novel_views.mp4")])
def test_videos_and_speed_info_as_jax(runs, kind, video):
    jdir, tdir = runs["tmp"] / "jax" / kind, runs["tmp"] / "port" / kind
    jn, jshape = _cv2_frames(jdir / video)
    tn, tshape = _cv2_frames(tdir / video)
    assert (tn, tshape) == (jn, jshape) and tn > 0
    v = read_video(str(tdir / video))
    assert v.frames.shape == (tn,) + tshape and v.fps == 30.0
    info_dir = Path(video).parent
    jinfo = json.loads((jdir / info_dir / "speed_info.json").read_text())
    tinfo = json.loads((tdir / info_dir / "speed_info.json").read_text())
    assert tinfo.keys() == jinfo.keys() == {"infer_time", "render_speed"}
    assert tinfo["infer_time"] > 0 and tinfo["render_speed"] > 0


def test_results_dict_as_jax(runs):
    j, t = runs["jax"]["results"], runs["port"]["results"]
    assert t.keys() == j.keys() == {"vid000"}
    assert t["vid000"].keys() == j["vid000"].keys()
    assert t["vid000"]["frames"] == j["vid000"]["frames"] == N_FRAMES
    assert runs["port"]["cross"] is None and runs["port"]["novel"] is None


def test_avatar_ply_equals_jax(runs):
    """The PLY of each package's own avatar. The port face-sorts the pruned UV
    set for its planned gather, so its UV rows are the JAX rows in the plan's
    order."""
    jply = load_gaussian_ply(str(runs["tmp"] / "jax" / "self" / "vid000" / "avatar.ply"))
    tply = load_gaussian_ply(str(runs["tmp"] / "port" / "self" / "vid000" / "avatar.ply"))
    assert tply.keys() == jply.keys()
    javatar, _ = runs["jpipe"].infer_avatar(runs["tds"][0]["source"])
    V = javatar.vtx_positions.shape[1]
    plan = build_face_sort_plan(np.asarray(javatar.uv_binding_face),
                                np.asarray(javatar.uv_valid))
    order = np.concatenate([np.arange(V), V + np.asarray(plan.perm)])
    for k in jply:
        assert tply[k].shape == jply[k].shape, k
        np.testing.assert_allclose(tply[k], jply[k][order], atol=PLY_ATOL, rtol=0, err_msg=k)


def test_canonical_gaussians_equal_jax(runs):
    pipe = tinf.FramePipeline.from_runtime(runs["trt"])
    avatar, _ = pipe.infer_avatar(runs["source"], prune=False)
    jav = JAvatar(**{k: jnp.asarray(getattr(avatar, k).numpy()) for k in JAvatar._fields})
    want = jcanonical(jav, runs["jrt"].statics.faces)
    got = canonical_gaussians(avatar, pipe.faces)
    for k in got._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=PLY_ATOL, rtol=0, err_msg=k)


def test_change_id_info_equals_jax():
    rng = np.random.default_rng(0)
    tgt = {k: rng.standard_normal(3) for k in ("shape", "body_pose", "flame_exp", "head_scale")}
    src = {k: rng.standard_normal(3) for k in ("shape", "joints_offset", "flame_shape", "exp")}
    got, want = tinf.change_id_info(tgt, src), jinf.change_id_info(tgt, src)
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] for k in got)


def test_group_frames_give_the_sequential_pngs(runs, tmp_path):
    trt = runs["trt"]
    tinf.render_set(trt, trt.model, runs["tds"], str(tmp_path), group_frames=2,
                    export_ply=False)
    seq = runs["tmp"] / "port" / "self"
    names = _pngs(tmp_path)
    assert names == [n for n in _pngs(seq)]
    for name in names:
        assert np.array_equal(read_rgb(str(tmp_path / name)), read_rgb(str(seq / name))), name
    assert not (tmp_path / "vid000" / "avatar.ply").exists()


def test_dp_frames_on_one_device_is_sequential(runs, tmp_path):
    trt = runs["trt"]
    res = tinf.render_set(trt, trt.model, runs["tds"], str(tmp_path), dp_frames=True,
                          max_frames=1, export_ply=False)
    assert res["vid000"]["frames"] == 1
    seq = runs["tmp"] / "port" / "self" / "vid000" / "render" / "000000.png"
    assert np.array_equal(read_rgb(str(tmp_path / "vid000" / "render" / "000000.png")),
                          read_rgb(str(seq)))


def test_dp_frames_over_devices_names_slice_10(runs, tmp_path, monkeypatch):
    """dp_frames over several devices runs on the ranks of a process group
    (tests/test_torch_batch_render.py renders over two); outside a group a
    process drives one device, so more visible cards change no frame."""
    trt = runs["trt"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    res = tinf.render_set(trt, trt.model, runs["tds"], str(tmp_path), dp_frames=True,
                          max_frames=2, export_ply=False)
    assert tinf.current_group() is None and res["vid000"]["frames"] == 2
    seq = runs["tmp"] / "port" / "self" / "vid000" / "render"
    for name in ("000000.png", "000001.png"):
        assert np.array_equal(read_rgb(str(tmp_path / "vid000" / "render" / name)),
                              read_rgb(str(seq / name))), name


def test_params_must_be_the_runtimes_modules(runs, tmp_path):
    trt = runs["trt"]
    other = torch.nn.ModuleDict({"inferer": torch.nn.Identity(), "renderer": trt.renderer})
    with pytest.raises(ValueError, match="runtime's own modules"):
        tinf.render_set(trt, other, runs["tds"], str(tmp_path))


def test_speed_meter_synchronizes_a_cuda_device(monkeypatch):
    """Every timed region waits for the card at its start and before its end
    reads the clock; a CPU meter calls no CUDA."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    cuda = logging_utils.SpeedMeter(torch.device("cuda"))
    with cuda.time_infer():
        assert len(calls) == 1
    with cuda.time_frame():
        assert len(calls) == 3
    with cuda.time_frames(2):
        assert len(calls) == 5
    assert len(calls) == 6 and all(d == torch.device("cuda") for d in calls)
    assert cuda.infer_time_ms is not None and len(cuda._render_times) == 3
    cpu = logging_utils.SpeedMeter(torch.device("cpu"))
    with cpu.time_infer(), cpu.time_frame():
        pass
    assert len(calls) == 6


def test_drivers_time_on_the_pipelines_device(runs, tmp_path, monkeypatch):
    seen = []
    real = tinf.SpeedMeter

    def meter(device=None):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(tinf, "SpeedMeter", meter)
    trt = runs["trt"]
    tinf.render_cross_set(trt, trt.model, runs["tds"], runs["tds"], str(tmp_path), max_frames=1)
    assert seen == [torch.device("cpu")]
