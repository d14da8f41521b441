"""The port's offline evaluation (`train/metrics.py`) against the JAX
package's, on a tree of render/gt images the test writes."""

import json
import shutil
import sys

import cv2
import numpy as np
import pytest

from guava_renderer_tpu.train import metrics as jmetrics
from guava_renderer_tpu_torch.train import metrics as pmetrics

TOL = 1e-5


def _write_tree(root, seed=0):
    rng = np.random.default_rng(seed)
    for scene, ext in (("scene_a", "png"), ("scene_b", "jpg")):
        for sub in ("render", "gt"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(3):
            gt = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
            render = np.clip(gt.astype(int) + rng.integers(-30, 30, gt.shape), 0, 255)
            cv2.imwrite(str(root / scene / "gt" / f"{i:05d}.{ext}"), gt)
            cv2.imwrite(str(root / scene / "render" / f"{i:05d}.{ext}"), render.astype(np.uint8))
    (root / "not_a_scene").mkdir()


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("with_lpips", [False, True], ids=["lpips_skipped", "lpips_fn"])
def test_evaluate_tree_equals_jax(tmp_path, with_lpips):
    _write_tree(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    p_fn = j_fn = None
    if with_lpips:      # any image distance stands in for LPIPS: the hook is what is tested
        p_fn = lambda r, g: float(((r - g) ** 2).mean()) * 3.0       # noqa: E731
        j_fn = lambda r, g: float(((r - g) ** 2).mean()) * 3.0       # noqa: E731
    got = pmetrics.evaluate_tree(str(tmp_path / "port"), p_fn)
    ref = jmetrics.evaluate_tree(str(tmp_path / "jax"), j_fn)
    _close(got, ref)
    assert ("lpips_skipped" in got["aggregate"]) == (not with_lpips)
    for rel in ("results.json", "scene_a/per_view.json", "scene_a/results.json",
                "scene_b/per_view.json", "scene_b/results.json"):
        _close(json.loads((tmp_path / "port" / rel).read_text()),
               json.loads((tmp_path / "jax" / rel).read_text()), rel)
    assert got["aggregate"]["psnr"] > 10 and len(got["scenes"]) == 2


def test_face_identity_similarity_is_gated_as_in_jax(monkeypatch):
    """Without the insightface package both return None."""
    monkeypatch.setitem(sys.modules, "insightface", None)
    monkeypatch.setitem(sys.modules, "insightface.app", None)
    img = np.zeros((8, 8, 3), np.float32)
    assert pmetrics.face_identity_similarity(img, [img]) is None
    assert jmetrics.face_identity_similarity(img, [img]) is None
