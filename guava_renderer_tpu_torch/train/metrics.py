"""Offline evaluation: PSNR / SSIM / LPIPS / MAE over render vs GT dumps
(counterpart of `guava_renderer_tpu/train/metrics.py`).

Parity with the reference's evaluate() (ref: main/metrics.py:84-183): walks
`render/` vs `gt/` image directories per scene, computes per-frame metrics,
writes per_view.json + results.json per scene and an aggregate results.json.

The identity metric (ref: main/metrics_face.py, InsightFace cosine
similarity) is gated on the insightface package, which is not bundled; the
hook is provided so environments that have it produce the same JSON field.

Images are read with the port's codec (`data/codec.py:read_rgb`, the
pixels OpenCV's `imread` gives). `lpips_fn(r, g)` takes (1, H, W, 3)
tensors in [0, 1].
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.codec import read_rgb
from ..ops.ssim import psnr as _psnr
from ..ops.ssim import ssim as _ssim


def _load_image(path: str) -> np.ndarray:
    return read_rgb(path).astype(np.float32) / 255.0


def evaluate_dirs(
    scene_dir: str,
    lpips_fn=None,
    render_name: str = "render",
    gt_name: str = "gt",
) -> dict:
    """Evaluate one scene directory containing render/ and gt/ subdirs."""
    rdir = os.path.join(scene_dir, render_name)
    gdir = os.path.join(scene_dir, gt_name)
    names = sorted(os.listdir(rdir))
    per_view = {"psnr": {}, "ssim": {}, "lpips": {}, "mae": {}}
    for name in names:
        r = _load_image(os.path.join(rdir, name))[None]
        g = _load_image(os.path.join(gdir, name))[None]
        rt, gt = torch.from_numpy(r), torch.from_numpy(g)
        per_view["psnr"][name] = float(_psnr(rt, gt)[0])
        per_view["ssim"][name] = float(_ssim(rt, gt))
        per_view["mae"][name] = float(np.abs(r - g).mean())
        if lpips_fn is not None:
            per_view["lpips"][name] = float(lpips_fn(rt, gt))
    results = {
        k: (sum(v.values()) / len(v)) if v else None for k, v in per_view.items()
    }
    if lpips_fn is None:
        # loud skip: a silently-missing headline metric reads as "computed
        # and bad" — record WHY it is null (no converted LPIPS-vgg weights)
        results["lpips_skipped"] = "no converted LPIPS weights"
    with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
        json.dump(per_view, f, indent=2)
    with open(os.path.join(scene_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def evaluate_tree(root: str, lpips_fn=None) -> dict:
    """Aggregate over scene subdirectories (the reference's outer loop)."""
    scenes = [
        d for d in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, d, "render"))
    ]
    all_results = {}
    for s in scenes:
        all_results[s] = evaluate_dirs(os.path.join(root, s), lpips_fn)
    agg = {}
    for key in ("psnr", "ssim", "lpips", "mae"):
        vals = [r[key] for r in all_results.values() if r.get(key) is not None]
        agg[key] = sum(vals) / len(vals) if vals else None
    if agg.get("lpips") is None and lpips_fn is None:
        agg["lpips_skipped"] = "no converted LPIPS weights"
    out = {"scenes": all_results, "aggregate": agg}
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def face_identity_similarity(source_img: np.ndarray, renders: list[np.ndarray]):
    """InsightFace identity cosine similarity (ref: main/metrics_face.py:9-30).

    Returns None when the insightface package is unavailable."""
    try:
        from insightface.app import FaceAnalysis
    except ImportError:
        return None
    app = FaceAnalysis(name="buffalo_l")
    app.prepare(ctx_id=-1)

    def embed(img):
        faces = app.get((img * 255).astype(np.uint8)[..., ::-1])
        return None if not faces else faces[0].normed_embedding

    src = embed(source_img)
    if src is None:
        return None
    sims = []
    for r in renders:
        e = embed(r)
        if e is not None:
            sims.append(float(np.dot(src, e)))
    return sum(sims) / len(sims) if sims else None
