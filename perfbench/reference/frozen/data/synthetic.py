"""Synthetic tracked-dataset builder (tests / demos without real captures;
counterpart of `guava_renderer_tpu/data/synthetic.py`).

The same numpy draws in the same order as the JAX writer, so the `.pkl`
and `.json` files are equal for the same arguments; the images go through
the port's codec (JPEG at quality 95, OpenCV's default, and PNG masks).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from .codec import encode_jpeg, encode_png
from .store import RecordStoreWriter


def write_synthetic_dataset(
    path: str,
    n_videos: int = 2,
    n_frames: int = 6,
    image_size: int = 128,
    n_shape: int = 20,
    n_exp: int = 10,
    seed: int = 0,
    image_mode: str = "noise",
    frozen_motion: bool = False,
) -> None:
    """Emit a directory with the full tracked-video layout.

    image_mode: "noise" (default — exercises IO/shapes) or "smooth"
    (band-limited gradients+blobs a renderer can actually fit — used by the
    overfit-one-frame convergence run). frozen_motion repeats frame 0's
    coefficients and image for every frame, so the train pair and the
    validation targets are the SAME image (single-frame overfitting)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)

    tracked: dict = {}
    id_share: dict = {}
    videos_info: dict = {}
    frames = {"train": [], "valid": []}

    writer = RecordStoreWriter(os.path.join(path, "img_store.grv"))
    for v in range(n_videos):
        vid = f"vid{v:03d}"
        keys = [f"{f:06d}" for f in range(n_frames)]
        videos_info[vid] = {"frames_keys": keys}
        id_share[vid] = {
            "smplx_shape": rng.normal(size=(1, n_shape)).astype(np.float32) * 0.3,
            "joints_offset": rng.normal(size=(1, 55, 3)).astype(np.float32) * 0.005,
            "head_scale": np.ones((1, 3), np.float32),
            "hand_scale": np.ones((1, 3), np.float32),
            "flame_shape": rng.normal(size=(1, n_shape)).astype(np.float32) * 0.3,
        }
        tracked[vid] = {}
        frame0 = None
        img0 = None
        for i, fk in enumerate(keys):
            RT = np.eye(4, dtype=np.float32)[:3]
            RT[:, 3] = [0.0, 0.0, 6.0]
            # pytorch3d convention stores the pre-flip matrix
            RT[:2] *= -1
            record = {
                "smplx_coeffs": {
                    "body_pose": (rng.normal(size=(21, 3)) * 0.05).astype(np.float32),
                    "global_pose": np.zeros((1, 3), np.float32),
                    "left_hand_pose": np.zeros((15, 3), np.float32),
                    "right_hand_pose": np.zeros((15, 3), np.float32),
                    "camera_RT_params": RT,
                },
                "flame_coeffs": {
                    "expression_params": (rng.normal(size=(n_exp,)) * 0.2).astype(np.float32),
                    "jaw_params": np.zeros(3, np.float32),
                    "eye_pose_params": np.zeros(6, np.float32),
                    "eyelid_params": np.zeros(2, np.float32),
                },
            }
            if frozen_motion:
                if frame0 is None:
                    frame0 = record
                record = frame0
            tracked[vid][fk] = record
            if image_mode == "smooth":
                yy, xx = np.mgrid[0:image_size, 0:image_size] / image_size
                img = np.stack(
                    [
                        0.5 + 0.45 * np.sin(2 * np.pi * (xx * 1.5 + v + i * 0.1)),
                        0.5 + 0.45 * np.cos(2 * np.pi * (yy * 1.2 - i * 0.07)),
                        np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05),
                    ],
                    axis=-1,
                )
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            else:
                img = (rng.uniform(0, 255, (image_size, image_size, 3))).astype(np.uint8)
            if frozen_motion:
                if img0 is None:
                    img0 = img
                img = img0
            mask = np.zeros((image_size, image_size), np.uint8)
            mask[image_size // 4 : -image_size // 4, image_size // 4 : -image_size // 4] = 255
            writer.put(f"{vid}/{fk}/body_image", encode_jpeg(img, 95))
            writer.put(f"{vid}/{fk}/body_mask", encode_png(mask))
            frames["train" if i < n_frames - 2 else "valid"].append(f"{vid}/{fk}")
    writer.close()

    with open(os.path.join(path, "optim_tracking_ehm.pkl"), "wb") as f:
        pickle.dump(tracked, f)
    with open(os.path.join(path, "id_share_params.pkl"), "wb") as f:
        pickle.dump(id_share, f)
    with open(os.path.join(path, "videos_info.json"), "w") as f:
        json.dump(videos_info, f)
    with open(os.path.join(path, "dataset_frames.json"), "w") as f:
        json.dump(frames, f)
