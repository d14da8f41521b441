"""The port's entry points on the CPU (`--device cpu`) on micro_synthetic.yaml
and a micro dataset the test writes: `python -m ...cli.test` in a subprocess,
`cli.create_avatar` -> `cli.render_motion`, `cli.metrics`, `cli.metrics_face`
and the app service (`cli/app.py`).

A model directory holds the config and the JAX runtime's `init_params` in
both packages' formats (`converted_params.msgpack` for the JAX package,
`converted_params.pt` for the port, carried over by convert.py), so the JAX
`create_avatar.py` and the port's create from the same weights."""

import argparse
import importlib
import json
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from guava_renderer_tpu.cli import context as jctx
from guava_renderer_tpu.train.checkpoints import load_pytree
from guava_renderer_tpu.train.metrics import evaluate_tree as jevaluate_tree
from guava_renderer_tpu.train.weights import save_converted_params as jsave_converted
from guava_renderer_tpu.utils.config import load_config as jload_config
from guava_renderer_tpu_torch.cli import app, create_avatar, metrics, metrics_face, render_motion
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.convert import model_from_flax
from guava_renderer_tpu_torch.data.codec import read_rgb
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.ops.facegather import build_face_sort_plan
from guava_renderer_tpu_torch.train.checkpoints import load_avatar
from guava_renderer_tpu_torch.train.weights import save_converted_params
from guava_renderer_tpu_torch.utils import video
from guava_renderer_tpu_torch.utils.config import load_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
AVATAR_ATOL = 1e-5
METRICS_ATOL = 1e-5
N_FRAMES = 4
BATCHED_UV = ("uv_local_xyz", "uv_colors", "uv_opacity", "uv_scales", "uv_rotations")
UV_ROWS = ("uv_binding_face", "uv_face_bary", "uv_valid")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(tmp, dataset dir, model dir, the JAX runtime and params)."""
    tmp = tmp_path_factory.mktemp("entry_points")
    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=N_FRAMES, image_size=48, n_shape=8,
                            n_exp=4)
    over = {"DATASET": {"data_path": data}}
    mdir = tmp / "model"
    mdir.mkdir()
    load_config(MICRO, over)._dump(str(mdir / "config.yaml"))

    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jrt = jctx.build_runtime(jload_config(MICRO, over), synthetic_assets=True)
    finally:
        mp.undo()
    with jax.default_prng_impl("unsafe_rbg"):
        params = jax.jit(lambda: jctx.init_params(jrt, seed=0))()["model"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jsave_converted(str(mdir / "converted_params.msgpack"), params)
    trt = tctx.build_runtime(load_config(MICRO, over), synthetic_assets=True, device="cpu")
    model_from_flax(params, trt.inferer, trt.renderer)
    save_converted_params(str(mdir / "converted_params.pt"), trt.model.state_dict())
    return types.SimpleNamespace(tmp=tmp, data=data, mdir=str(mdir), jrt=jrt, params=params)


@pytest.fixture(scope="module")
def self_run(model):
    """`python -m guava_renderer_tpu_torch.cli.test --device cpu` in a
    subprocess, as tests/test_cli_smoke.py runs main/test.py."""
    save = model.tmp / "test_results"
    r = subprocess.run(
        [sys.executable, "-m", "guava_renderer_tpu_torch.cli.test", "-m", model.mdir,
         "--data_path", model.data, "-s", str(save), "--synthetic_assets", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return save, r.stdout


def test_cli_test_subprocess(self_run, model):
    save, out = self_run
    assert f"converted reference weights {model.mdir}/converted_params.pt" in out
    scene = save / "vid000"
    for sub in ("render", "gt"):
        assert sorted(p.name for p in (scene / sub).iterdir()) == \
            [f"{i:06d}.png" for i in range(N_FRAMES)]
    assert (scene / "avatar.ply").is_file()
    v = video.read_video(str(scene / "vid000_compare.mp4"))
    assert v.frames.shape == (N_FRAMES, 32, 64, 3) and v.fps == 30.0
    info = json.loads((scene / "speed_info.json").read_text())
    assert info["infer_time"] > 0 and info["render_speed"] > 0
    assert "'vid000': {'frames': 4" in out


def test_cli_test_without_weights_exits_as_jax(model, tmp_path):
    from guava_renderer_tpu_torch.cli import test as cli_test

    empty = tmp_path / "empty"
    empty.mkdir()
    load_config(str(Path(model.mdir) / "config.yaml"))._dump(str(empty / "config.yaml"))
    with pytest.raises(SystemExit, match="no trained weights found"):
        cli_test.main(["-m", str(empty), "--data_path", model.data, "--device", "cpu"])


def _jax_create_avatar(model, out):
    """The root create_avatar.py in this process, on the fixture's JAX runtime
    and weights (its own un-jitted init would take ~30 s)."""
    sys.path.insert(0, str(ROOT))
    try:
        jcreate = importlib.import_module("create_avatar")
    finally:
        sys.path.remove(str(ROOT))
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_PLATFORMS", "cpu")
    mp.setattr(jctx, "build_runtime", lambda cfg, synthetic_assets=False: model.jrt)
    mp.setattr(jctx, "load_model_params",
               lambda rt, path, allow_random=False: (model.params, "the fixture's"))
    try:
        jcreate.create_avatar(argparse.Namespace(
            model_path=model.mdir, data_path=model.data, source_video_id="vid000",
            output_avatar_path=out, devices="cpu", platform="cpu",
            allow_random_weights=True, synthetic_assets=True))
    finally:
        mp.undo()
    return load_pytree(out, None)


def test_create_avatar_then_render_motion(model, tmp_path, capsys):
    path = str(tmp_path / "port_avatar.pt")
    made = create_avatar.main(["-m", model.mdir, "--data_path", model.data,
                               "--source_video_id", "vid000", "--output_avatar_path", path,
                               "--synthetic_assets", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "avatar inference: " in out and f"saved avatar to {path}" in out
    assert (tmp_path / "port_avatar.ply").is_file()
    got = load_avatar(path)
    for k in got._fields:
        assert torch.equal(getattr(got, k), getattr(made, k)), k

    # the JAX avatar from the same weights; the port's UV rows are face-sorted
    want = _jax_create_avatar(model, str(tmp_path / "jax_avatar"))
    plan = build_face_sort_plan(np.asarray(want["uv_binding_face"]),
                                np.asarray(want["uv_valid"]))
    for k in got._fields:
        w = np.asarray(want[k])
        if k in BATCHED_UV:
            w = w[:, plan.perm]
        elif k in UV_ROWS:
            w = w[plan.perm]
        g = getattr(got, k).numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=AVATAR_ATOL, rtol=0, err_msg=k)

    # an EMAGE-style track at 25 fps -> 30 fps, rendered at 48^2 (the refiner at 32^2)
    T = 6
    rng = np.random.default_rng(0)
    npz = str(tmp_path / "emage.npz")
    np.savez(npz, poses=(rng.standard_normal((T, 165)) * 0.1).astype(np.float32),
             mocap_frame_rate=np.asarray(25.0))
    seen = []
    from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner

    real_forward = NeuralRefiner.forward

    def recording_forward(self, x, *a, **kw):
        seen.append(tuple(x.shape))
        return real_forward(self, x, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(NeuralRefiner, "forward", recording_forward)
    try:
        mp4 = str(tmp_path / "motion.mp4")
        render_motion.main(["-a", path, "-m", model.mdir, "--smplx_motion", npz,
                            "--image_size", "48", "-o", mp4, "--synthetic_assets",
                            "--audio", npz, "--device", "cpu"])
    finally:
        mp.undo()
    n = int(np.floor((T - 1) / 25.0 * 30.0)) + 1
    v = video.read_video(mp4)
    assert v.frames.shape == (n, 48, 48, 3) and v.fps == 30.0
    assert seen and all(s[1:3] == (32, 32) for s in seen), seen
    out = capsys.readouterr().out
    assert f"wrote {n} frames to {mp4} at 48px" in out
    if shutil.which("ffmpeg") is None:
        assert "audio mux skipped" in out
    # a size the raster tile (16) does not divide is refused, as the JAX rasterizer refuses it
    with pytest.raises(ValueError, match="must tile by 16"):
        render_motion.main(["-a", path, "-m", model.mdir, "--smplx_motion", npz,
                            "--image_size", "40", "-o", str(tmp_path / "m40.mp4"),
                            "--synthetic_assets", "--device", "cpu"])
    assert not (tmp_path / "m40.mp4").exists()


def test_metrics_equal_jax(self_run, tmp_path, capsys):
    save, _ = self_run
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(save, jdir)
    shutil.copytree(save, tdir)
    outs = metrics.main(["-m", str(tdir), "--pretrained_dir", str(tmp_path / "none"),
                         "--device", "cpu"])
    assert "no converted LPIPS-vgg at" in capsys.readouterr().out
    want = jevaluate_tree(str(jdir))
    got = outs[str(tdir)]
    assert json.loads((tdir / "results.json").read_text()) == got
    for name in ("results.json", "per_view.json"):
        assert (tdir / "vid000" / name).is_file()
    for k, w in want["aggregate"].items():
        g = got["aggregate"][k]
        if isinstance(w, float):
            assert abs(g - w) <= METRICS_ATOL, k
        else:
            assert g == w, k
    assert all(np.isfinite(got["aggregate"][k]) for k in ("psnr", "ssim", "mae"))


def test_metrics_lpips_vgg_from_the_converted_file(self_run, tmp_path):
    from guava_renderer_tpu_torch.train.lpips import LPIPS, init_lpips_

    save, _ = self_run
    m = init_lpips_(LPIPS("vgg"), torch.Generator().manual_seed(0))
    save_converted_params(str(tmp_path / "lpips_vgg.pt"), m.state_dict())
    fn = metrics.build_lpips(str(tmp_path), "cpu")
    a = torch.from_numpy(read_rgb(str(save / "vid000" / "render" / "000000.png"))
                         .astype(np.float32) / 255)[None]
    b = torch.from_numpy(read_rgb(str(save / "vid000" / "gt" / "000000.png"))
                         .astype(np.float32) / 255)[None]
    assert fn(a, b) == pytest.approx(float(m(a, b)), abs=1e-7) and fn(a, b) > 0
    assert fn(a, a) == 0.0


def test_metrics_face_exits_as_jax_without_insightface(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        jface = importlib.import_module("main.metrics_face")
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setitem(sys.modules, "insightface", None)
    monkeypatch.setitem(sys.modules, "insightface.app", None)
    argv = ["--source_folder", str(tmp_path), "--render_folder", str(tmp_path)]
    with pytest.raises(SystemExit) as got:
        metrics_face.main(argv)
    monkeypatch.setattr(sys, "argv", ["metrics_face.py", *argv])
    with pytest.raises(SystemExit) as want:
        jface.main()
    assert str(got.value) == str(want.value) and "insightface is not installed" in str(got.value)


def _service(model, save_dir, max_frames=2):
    return app.GenerationService(types.SimpleNamespace(
        model_path=model.mdir, synthetic_assets=True, allow_random_weights=True,
        save_dir=str(save_dir), max_frames=max_frames, device="cpu"))


def test_app_never_returns_a_video_before_its_job_is_done(model, tmp_path, monkeypatch):
    """With the MP4 writer slowed, a 10 ms poll sees the video only once the
    job is done (the JAX service returns it as soon as the file exists), and
    the file it sees reads back whole."""
    real = video.encode_jpeg

    def slow_encode(img, quality):
        time.sleep(0.2)
        return real(img, quality)

    monkeypatch.setattr(video, "encode_jpeg", slow_encode)
    svc = _service(model, tmp_path)
    name = Path(model.data).name
    assert svc.check_status(None, "x")[1] is None
    assert "source" in svc.check_status(None, "x")[0].lower()
    assert "driving" in svc.check_status("x", None)[0].lower()
    assert "processing" in svc.check_status("never", "submitted")[0].lower()

    key = svc.submit(model.data, model.data)
    polls, deadline = [], time.time() + 300
    while time.time() < deadline:
        msg, path = svc.check_status(name, name)
        state = svc.jobs[key]["state"]
        polls.append((path is not None, state))
        if path is not None or state == "failed":
            break
        time.sleep(0.01)
    assert state == "done", svc.jobs[key]
    assert all(st == "done" for seen, st in polls if seen)
    assert polls[-1][0] and "completed" in msg.lower()
    assert len(video.read_video(path).frames) == 2
    assert len(polls) > 10        # polled while the job ran
    assert svc.submit(model.data, model.data) == key and svc.jobs[key]["state"] == "done"

    # an earlier process's result: no job known, the file exists
    fresh = _service(model, tmp_path)
    assert fresh.check_status(name, name)[1] == path
    assert fresh.submit(model.data, model.data) == key and key not in fresh.jobs

    bad = str(tmp_path / "missing_video")
    key2 = svc.submit(bad, model.data)
    deadline = time.time() + 120
    while time.time() < deadline and svc.jobs[key2]["state"] == "running":
        time.sleep(0.05)
    assert svc.jobs[key2]["state"] == "failed"
    msg, path = svc.check_status("missing_video", name)
    assert path is None and "failed" in msg.lower()


def test_app_stdlib_status_answers(model, tmp_path):
    svc = _service(model, tmp_path)
    args = types.SimpleNamespace(tracked_image_dir=str(tmp_path / "img"),
                                 tracked_video_dir=str(tmp_path / "vid"),
                                 save_dir=str(tmp_path), port=0)
    httpd = app.build_stdlib_app(args, svc)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/api/status?src=a&vid=b", timeout=10) as r:
            body = json.loads(r.read())
        assert body == {"status": "Still processing... You can check progress again later. ⏳",
                        "result": None}
        with urllib.request.urlopen(f"{base}/api/items", timeout=10) as r:
            assert json.loads(r.read()) == {"sources": [], "videos": []}
        with urllib.request.urlopen(f"{base}/", timeout=10) as r:
            assert b"Generate" in r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
