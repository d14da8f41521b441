"""The port's motion ingestion and orbit cameras (`guava_renderer_tpu_torch/motion.py`,
`utils/camera_orbit.py`) and its two motion entry points (`cli/convert_motion.py`,
`cli/resample_motion.py`) against the JAX package's: numpy on both sides, so
every array is equal bit for bit."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from guava_renderer_tpu import motion as jmotion
from guava_renderer_tpu.utils import camera_orbit as jorbit
from guava_renderer_tpu_torch import motion as tmotion
from guava_renderer_tpu_torch.cli import convert_motion, resample_motion
from guava_renderer_tpu_torch.utils import camera_orbit as torbit

ROOT = Path(__file__).resolve().parents[1]
T = 30


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("motion")
    rng = np.random.default_rng(0)
    out = {}
    out["smplx"] = str(tmp / "emage.npz")
    np.savez(out["smplx"], poses=rng.standard_normal((T, 165)) * 0.3,
             expressions=rng.standard_normal((T, 100)), trans=rng.standard_normal((T, 3)),
             mocap_frame_rate=np.asarray(25.0))
    out["smplx_bare"] = str(tmp / "poses_only.npz")
    np.savez(out["smplx_bare"], poses=(rng.standard_normal((T, 165)) * 0.3).astype(np.float32))
    out["flame_npy"] = str(tmp / "flame.npy")
    np.save(out["flame_npy"], rng.standard_normal((T, 56)))
    out["flame_npz"] = str(tmp / "flame.npz")
    np.savez(out["flame_npz"], expression_params=rng.standard_normal((T, 50)),
             jaw_params=rng.standard_normal((T, 3)), eyes=rng.standard_normal((T, 6)))
    out["bad_flame"] = str(tmp / "bad.npy")
    np.save(out["bad_flame"], rng.standard_normal((T, 20)))
    return tmp, out


@pytest.mark.parametrize("name", ["smplx", "smplx_bare"])
def test_load_smplx_motion(files, name):
    _, f = files
    _equal(tmotion.load_smplx_motion(f[name]), jmotion.load_smplx_motion(f[name]))


@pytest.mark.parametrize("name", ["flame_npy", "flame_npz"])
def test_load_flame_motion(files, name):
    _, f = files
    _equal(tmotion.load_flame_motion(f[name]), jmotion.load_flame_motion(f[name]))


def test_load_flame_motion_refuses_as_jax(files):
    _, f = files
    for mod in (tmotion, jmotion):
        with pytest.raises(ValueError, match="unrecognized flame motion layout"):
            mod.load_flame_motion(f["bad_flame"])


@pytest.mark.parametrize("src,dst", [(25.0, 30.0), (30.0, 25.0), (30.0, 30.0), (25.0, 60.0)])
def test_resample_motion(files, src, dst):
    _, f = files
    m = jmotion.load_smplx_motion(f["smplx"])
    got, want = tmotion.resample_motion(m, src, dst), jmotion.resample_motion(m, src, dst)
    _equal(got, want)
    if src == 25.0 and dst == 30.0:
        assert got["body_pose"].shape[0] == int(np.floor((T - 1) / 25.0 * 30.0)) + 1


@pytest.mark.parametrize("frame,flame,hand", [(0, None, 1.0), (7, "flame_npy", 0.5),
                                              (T + 5, "flame_npz", 1.0)])
@pytest.mark.parametrize("keep_global", [False, True])
def test_motion_frame_params(files, frame, flame, hand, keep_global):
    _, f = files
    sm = jmotion.load_smplx_motion(f["smplx"])
    fm = jmotion.load_flame_motion(f[flame]) if flame else None
    ident = {"shape": np.arange(8, dtype=np.float32), "head_scale": np.ones(3)}
    kw = dict(n_shape=8, n_exp=4, hand_pose_scale=hand, keep_global=keep_global)
    _equal(tmotion.motion_frame_params(sm, fm, frame, ident, **kw),
           jmotion.motion_frame_params(sm, fm, frame, ident, **kw))


@pytest.mark.parametrize("h,v,r", [(np.pi / 2, np.pi / 2 - 0.05, 5.0), (0.3, 0.0, 2.0),
                                   (2.0, np.pi, 7.5)])
def test_look_at_w2c(h, v, r):
    look = np.asarray([0.0, 0.75, 0.0])
    _equal(torbit.look_at_w2c(h, v, look, r), jorbit.look_at_w2c(h, v, look, r))


@pytest.mark.parametrize("n", [1, 4, 120])
def test_generate_novel_view_poses(n):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, 0.8, 4.0]
    got = torbit.generate_novel_view_poses(c2w, num_keyframes=n)
    want = jorbit.generate_novel_view_poses(c2w, num_keyframes=n)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        _equal(a, b)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("args", [
    ["--smplx_motion", "{smplx}"],
    ["--smplx_motion", "{smplx_bare}", "--src_fps", "25"],
    ["--smplx_motion", "{smplx}", "--flame_motion", "{flame_npz}", "--src_fps", "25",
     "--dst_fps", "30"],
    ["--flame_motion", "{flame_npy}"],
], ids=["smplx-own-fps", "smplx-25to30", "smplx-flame-25to30", "flame"])
def test_convert_motion_writes_the_root_scripts_npz(files, args):
    tmp, f = files
    args = [a.format(**f) for a in args]
    want, got = tmp / "want.npz", tmp / "got.npz"
    subprocess.run([sys.executable, str(ROOT / "convert_motion.py"), *args, "-o", str(want)],
                   check=True, capture_output=True, cwd=ROOT)
    assert convert_motion.main([*args, "-o", str(got)]) == str(got)
    _equal(_npz(got), _npz(want))


@pytest.mark.parametrize("src,dst", [(25, 30), (30, 25)])
def test_resample_motion_writes_the_root_scripts_npz(files, src, dst):
    tmp, f = files
    args = ["-i", f["smplx"], "--src_fps", str(src), "--dst_fps", str(dst)]
    want, got = tmp / "rwant.npz", tmp / "rgot.npz"
    subprocess.run([sys.executable, str(ROOT / "resample_motion.py"), *args, "-o", str(want)],
                   check=True, capture_output=True, cwd=ROOT)
    resample_motion.main([*args, "-o", str(got)])
    _equal(_npz(got), _npz(want))
