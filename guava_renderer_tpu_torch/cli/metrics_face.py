"""Identity-similarity metrics entry point (counterpart of `main/metrics_face.py`).

    python -m guava_renderer_tpu_torch.cli.metrics_face --source_folder <images>
        --render_folder <renders>

For every source image, walks <render_folder>/<source_name>/*/render/,
embeds faces with InsightFace, averages the cosine similarity against the
source's embedding, and writes result.json at the subfolder, source and
root levels. Images are read by the port's codec (`data/codec.py:read_rgb`,
RGB) and handed to InsightFace in BGR, the order `cv2.imread` gives it.

InsightFace is not bundled; without it the entry point exits with a message.
"""

from __future__ import annotations

import argparse
import json
import os


def save_json(path: str, total_sim: float, n: int) -> None:
    with open(path, "w") as f:
        json.dump({"face_similarity_avg": float(total_sim / n) if n else 0.0,
                   "face_similarity_total": float(total_sim),
                   "total_images": n}, f, indent=4)


class FaceComparator:
    """InsightFace embedding extractor (ref: metrics_face.py:10-37)."""

    def __init__(self):
        from insightface.app import FaceAnalysis  # gated import

        self.app = FaceAnalysis(providers=["CPUExecutionProvider"])
        self.app.prepare(ctx_id=0)

    def get_features(self, img_path: str):
        import numpy as np

        from ..data.codec import read_rgb

        try:
            img = read_rgb(img_path)
        except (OSError, ValueError):
            return None          # cv2.imread's None: unreadable or not an image
        faces = self.app.get(np.ascontiguousarray(img[..., ::-1]))
        if not faces:
            return None
        return sorted(faces, key=lambda x: x.bbox[0])[0].normed_embedding

    def folder_similarity(self, source_feat, folder: str):
        import numpy as np

        total, count = 0.0, 0
        for name in sorted(os.listdir(folder)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            feat = self.get_features(os.path.join(folder, name))
            if feat is not None:
                total += float(np.dot(source_feat, feat.T))
                count += 1
        return total, count


def process_source(cmp: FaceComparator, source_path: str, render_root: str):
    base = os.path.splitext(os.path.basename(source_path))[0]
    target = os.path.join(render_root, base)
    if not os.path.isdir(target):
        print(f"[metrics_face] no renders for {base}")
        return 0.0, 0
    feat = cmp.get_features(source_path)
    if feat is None:
        print(f"[metrics_face] no face found in {source_path}")
        return 0.0, 0
    total, count = 0.0, 0
    for sub in sorted(os.listdir(target)):
        rdir = os.path.join(target, sub, "render")
        if not os.path.isdir(rdir):
            continue
        s, n = cmp.folder_similarity(feat, rdir)
        if n:
            save_json(os.path.join(target, sub, "result.json"), s, n)
            total += s
            count += n
    if count:
        save_json(os.path.join(target, "result.json"), total, count)
    return total, count


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-level face-identity metrics")
    ap.add_argument("--source_folder", type=str, required=True)
    ap.add_argument("--render_folder", type=str, required=True)
    args = ap.parse_args(argv)

    try:
        cmp = FaceComparator()
    except ImportError:
        raise SystemExit(
            "insightface is not installed in this environment — the identity "
            "metric needs it (the PSNR/SSIM/LPIPS/MAE driver main/metrics.py "
            "runs without it).")

    total, count = 0.0, 0
    for name in sorted(os.listdir(args.source_folder)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        s, n = process_source(cmp, os.path.join(args.source_folder, name), args.render_folder)
        total += s
        count += n
    if count:
        save_json(os.path.join(args.render_folder, "result.json"), total, count)
        print(f"face_similarity_avg={total / count:.4f} over {count} images")


if __name__ == "__main__":
    main()
