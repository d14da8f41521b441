"""Self-consistent "teacher" dataset for convergence evidence (counterpart
of `tools/make_teacher_dataset.py`).

Writes a synthetic tracked dataset (bodymodel/synthetic rig motion), then
replaces its placeholder images with renders of a fixed procedural teacher
avatar produced by this package's own pipeline at every tracked pose. The
pose -> image mapping is exactly representable by the model family, so a
training run that generalizes to the held-out validation frames (new
poses, same identities) shows the loss and optimizer learning.

The teacher avatar comes from running the inferer once a video (for the
binding tables and shapes), then overriding its appearance with smooth
deterministic fields: RGB = sinusoids of canonical position (a phase a
video, so identities differ), high opacity, edge-length-scaled splats.
Images are JPEG at quality 98, masks PNG, through the port's codec.

    python -m guava_renderer_tpu_torch.tools.make_teacher_dataset --out DIR \\
        -c configs/train/teacher128_synthetic.yaml --videos 2 --frames 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def teacher_avatar(avatar, faces: np.ndarray, phase: float):
    """Override appearance with smooth deterministic fields."""
    dev = avatar.vtx_positions.device
    vtx = avatar.vtx_positions.detach().cpu().numpy()          # (1, V, 3)
    # mean edge length sets a splat scale that tiles the surface
    tri = vtx[0][faces]                                         # (F, 3, 3)
    e = np.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1)
    s0 = float(np.mean(e))

    def rgb_of(pos):
        x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
        freq = 6.0
        return np.stack([
            0.5 + 0.45 * np.sin(freq * x + phase),
            0.5 + 0.45 * np.sin(freq * y + 2.1 + phase),
            0.5 + 0.45 * np.sin(freq * z + 4.2 + phase),
        ], axis=-1).astype(np.float32)

    V = vtx.shape[1]
    vtx_colors = np.zeros((1, V, 32), np.float32)
    vtx_colors[..., :3] = rgb_of(vtx)
    N = avatar.uv_local_xyz.shape[1]
    uv_valid = avatar.uv_valid.cpu().numpy().astype(bool)
    # uv gaussians sit on their binding faces: color by face centroid
    fctr = tri.mean(axis=1)                                     # (F, 3)
    uv_pos = fctr[avatar.uv_binding_face.cpu().numpy()]
    uv_colors = np.zeros((1, N, 32), np.float32)
    uv_colors[..., :3] = rgb_of(uv_pos)[None]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ident = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (1, V, 1))
    identu = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (1, N, 1))
    return avatar._replace(
        vtx_colors=t(vtx_colors),
        vtx_opacity=t(np.full((1, V, 1), 0.92)),
        vtx_scales=t(np.full((1, V, 3), 0.6 * s0)),
        vtx_rotations=t(ident),
        uv_colors=t(uv_colors),
        uv_opacity=t(0.92 * uv_valid[None, :, None]),
        uv_scales=t(np.full((1, N, 3), 0.5 * s0)),
        uv_rotations=t(identu),
        uv_local_xyz=t(np.zeros((1, N, 3))),
    )


def make_teacher_dataset(out: str, config: str, videos: int = 2, frames: int = 16,
                         seed: int = 7, device="cuda", log=print) -> dict[str, float]:
    """Write the dataset -> {"<video>/<frame>": the render's mask coverage}."""
    from ..cli.context import build_runtime, init_params, resolve_config
    from ..cli.inference import FramePipeline
    from ..data.codec import encode_jpeg, encode_png
    from ..data.store import RecordStoreWriter
    from ..data.synthetic import write_synthetic_dataset
    from ..data.tracked import TrackedVideoDataset, _resize
    from ..device import resolve_device

    device = resolve_device(device)      # before anything is written
    cfg = resolve_config(config)
    m = cfg.MODEL
    write_synthetic_dataset(
        out, n_videos=videos, n_frames=frames, image_size=int(cfg.DATASET.origin_image_size),
        n_shape=int(m.synthetic_n_shape), n_exp=int(m.synthetic_n_exp), seed=seed,
        image_mode="smooth")
    log(f"[teacher] wrote motion skeleton: {videos} videos x {frames} frames")

    rt = init_params(build_runtime(cfg, synthetic_assets=True, device=device), seed=seed)
    pipe = FramePipeline.from_runtime(rt)
    ds = TrackedVideoDataset(out, "test", image_size=int(m.image_size),
                             feature_img_size=int(m.feature_img_size),
                             origin_image_size=int(cfg.DATASET.origin_image_size))
    faces = rt.statics.faces.cpu().numpy()

    # render every frame of every video with its per-video teacher
    renders: dict[str, bytes] = {}
    coverage: dict[str, float] = {}
    for vi, (vid, info) in enumerate(sorted(ds.videos_info.items())):
        keys = info["frames_keys"]
        src = ds._load_info(vid, keys[0])
        source = {"image": _resize(src["image"] * src["mask"], int(m.feature_img_size)),
                  "w2c": src["w2c"], "params": src}
        avatar, _ = pipe.infer_avatar(source, prune=False)
        avatar = teacher_avatar(avatar, faces, phase=2.39996 * vi)
        for fk in keys:
            rec = ds._load_info(vid, fk)
            out_ = pipe.render_frame(avatar, {"params": rec, "w2c": rec["w2c"]})
            img = out_["raw"].cpu().numpy()
            mask = (out_["invdepth"].cpu().numpy() > 1e-8).astype(np.uint8) * 255
            img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            renders[f"{vid}/{fk}/body_image"] = encode_jpeg(img8, 98)
            renders[f"{vid}/{fk}/body_mask"] = encode_png(mask)
            coverage[f"{vid}/{fk}"] = cov = float((mask > 0).mean())
            log(f"[teacher] {vid}/{fk}: coverage={cov:.2%}")

    # rewrite the store with teacher renders
    ds.store.close()
    store_path = os.path.join(out, "img_store.grv")
    os.remove(store_path)
    with RecordStoreWriter(store_path) as writer:
        for k, v in renders.items():
            writer.put(k, v)
    log(f"[teacher] rewrote {store_path} with {len(renders)} records")
    return coverage


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/teacher_ds")
    ap.add_argument("-c", "--config", default="configs/train/teacher128_synthetic.yaml")
    ap.add_argument("--videos", type=int, default=2)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return make_teacher_dataset(args.out, args.config, args.videos, args.frames, args.seed,
                                args.device)


if __name__ == "__main__":
    main()
