"""Tracked-video dataset (counterpart of `guava_renderer_tpu/data/tracked.py`:
the reference's on-disk layout, numpy/NHWC out).

Layout parity (ref: dataset/data_loader.py:15-199): a data directory holds
  optim_tracking_ehm.pkl   per-video, per-frame smplx/flame coeffs + crops
  id_share_params.pkl      per-identity shape/joints_offset/head+hand scale
  videos_info.json         frame key lists per video
  dataset_frames.json      train/valid split ("video/frame" keys)
  img_store.grv            JPEG body_image / body_mask per frame
                           (RecordStore replacing the reference's img_lmdb)

Record semantics match the reference: random same-video source frame at
train time (frame 0 otherwise), source image masked + resized to the
feature size, target at render size, the PyTorch3D->COLMAP camera flip
diag(-1,-1,1,1) (ref :121-138), and head/hand crop boxes recovered from the
stored crop homographies (ref :143-185).

Images are decoded and resized by the port's codec (`data/codec.py`), whose
pixels equal OpenCV's `imdecode` and `INTER_AREA` resize that the JAX
package calls.
"""

from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np

from .codec import decode_image, resize_area
from .store import RecordStore

C2C_FLIP = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)

_decode_image = decode_image        # the names of the JAX module's cv2 helpers
_resize = resize_area


def _to_f32(img: np.ndarray) -> np.ndarray:
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    return img


class TrackedVideoDataset:
    """Map-style dataset over tracked frames; returns numpy records."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        image_size: int = 512,
        feature_img_size: int = 518,
        origin_image_size: int = 1024,
        head_crop_size: int = 512,
        hand_crop_size: int = 512,
        seed: int = 0,
        test_full: bool = False,
    ):
        assert split in ("train", "valid", "test")
        self.split = split
        self.image_size = image_size
        self.feature_img_size = feature_img_size
        self.origin_image_size = origin_image_size
        self.head_crop_size = head_crop_size
        self.hand_crop_size = hand_crop_size
        self.data_path = data_path
        self._rng = random.Random(seed)

        with open(os.path.join(data_path, "optim_tracking_ehm.pkl"), "rb") as f:
            self.tracked = pickle.load(f)
        with open(os.path.join(data_path, "id_share_params.pkl"), "rb") as f:
            self.id_share = pickle.load(f)
        with open(os.path.join(data_path, "videos_info.json")) as f:
            self.videos_info = json.load(f)
        if split in ("train", "valid"):
            with open(os.path.join(data_path, "dataset_frames.json")) as f:
                self.frames = json.load(f)[split]
        else:
            # test split: `testing_split.json` maps video -> number of
            # trailing frames reserved for testing; --non_test_full renders
            # every frame instead (ref: data_loader.py:206-214, test.py:62).
            split_path = os.path.join(data_path, "testing_split.json")
            if os.path.exists(split_path) and not test_full:
                with open(split_path) as f:
                    self.testing_split = json.load(f)
            else:
                self.testing_split = {
                    vid: len(info["frames_keys"])
                    for vid, info in self.videos_info.items()
                }
            self.frames = [
                f"{vid}/{fk}"
                for vid, info in self.videos_info.items()
                for fk in info["frames_keys"][-int(self.testing_split.get(vid, len(info["frames_keys"]))):]
            ]
        self._store: RecordStore | None = None

    def __getstate__(self) -> dict:
        # the store's native handle stays behind; a copy (a spawned rank's) reopens it
        return {**self.__dict__, "_store": None}

    # lazily opened (fork-safe for worker processes/threads)
    @property
    def store(self) -> RecordStore:
        if self._store is None:
            self._store = RecordStore(os.path.join(self.data_path, "img_store.grv"))
        return self._store

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, index: int) -> dict:
        vid, fk = self.frames[index].split("/")
        src_key = self._choose_source(vid, fk)
        src = self._load_info(vid, src_key)
        tgt = self._load_info(vid, fk)

        src_img = src.pop("image") * src.pop("mask")
        src_img = _resize(src_img, self.feature_img_size)

        tgt_img = _resize(tgt.pop("image"), self.image_size)
        tgt_mask = _resize(tgt.pop("mask"), self.image_size)
        if tgt_mask.ndim == 2:
            tgt_mask = tgt_mask[..., None]

        return {
            "source": {"image": src_img, "w2c": src.pop("w2c"), "params": src},
            "target": {
                "image": tgt_img,
                "mask": tgt_mask,
                "w2c": tgt.pop("w2c"),
                "boxes": tgt.pop("boxes"),
                "params": tgt,
            },
        }

    # -- internals ---------------------------------------------------------
    def _choose_source(self, vid: str, fk: str) -> str:
        keys = self.videos_info[vid]["frames_keys"]
        if self.split == "train":
            cands = [k for k in keys if k != fk]
            return self._rng.choice(cands) if cands else fk
        return keys[0]

    def _load_info(self, vid: str, fk: str) -> dict:
        img = _to_f32(_decode_image(self.store.get(f"{vid}/{fk}/body_image")))
        mask = _to_f32(_decode_image(self.store.get(f"{vid}/{fk}/body_mask")))

        rec = self.tracked[vid][fk]
        share = self.id_share[vid]
        sm = {k: np.asarray(v, np.float32) for k, v in rec["smplx_coeffs"].items()}
        fl = {k: np.asarray(v, np.float32) for k, v in rec["flame_coeffs"].items()}

        RT = np.asarray(sm.pop("camera_RT_params"), np.float32).reshape(3, 4)
        M = np.eye(4, dtype=np.float32)
        M[:3, :4] = RT
        w2c = C2C_FLIP @ M

        boxes = self._boxes(rec)

        params = {
            "shape": np.asarray(share["smplx_shape"], np.float32).reshape(-1),
            "joints_offset": np.asarray(share["joints_offset"], np.float32).reshape(55, 3),
            "head_scale": np.asarray(share["head_scale"], np.float32).reshape(-1),
            "hand_scale": np.asarray(share["hand_scale"], np.float32).reshape(-1),
            "body_pose": sm["body_pose"],
            "global_pose": sm.get("global_pose"),
            "left_hand_pose": sm.get("left_hand_pose"),
            "right_hand_pose": sm.get("right_hand_pose"),
            "flame_shape": np.asarray(share["flame_shape"], np.float32).reshape(-1),
            "flame_exp": fl["expression_params"].reshape(-1),
            "flame_jaw": fl["jaw_params"].reshape(-1),
            "flame_eyes": fl.get("eye_pose_params"),
            "flame_eyelids": fl.get("eyelid_params"),
        }
        params = {k: v for k, v in params.items() if v is not None}
        params["image"] = img
        params["mask"] = mask
        params["w2c"] = w2c
        params["boxes"] = boxes
        return params

    def _boxes(self, rec: dict) -> dict:
        """Crop homographies -> [l, r, t, b] boxes at render resolution
        (ref: data_loader.py:143-185)."""
        scale = self.image_size / self.origin_image_size
        S = self.image_size

        def box_from(crop_key: str, crop_size: int) -> np.ndarray:
            if "body_crop" not in rec or crop_key not in rec:
                return np.asarray([0, S - 1, 0, S - 1], np.int64)
            corners = np.array(
                [[0, 0, 1], [crop_size, 0, 1], [0, crop_size, 1], [crop_size, crop_size, 1]],
                np.float32,
            )
            M = np.asarray(rec["body_crop"]["M_o2c-hd"], np.float32) @ np.asarray(
                rec[crop_key]["M_c2o"], np.float32
            )
            pts = (M @ corners[:, :, None])[:, :2, 0] * scale
            pts = np.clip(pts, 0, S - 1)
            l, r = int(pts[:, 0].min()), int(pts[:, 0].max())
            t, b = int(pts[:, 1].min()), int(pts[:, 1].max())
            if l == r or t == b:
                return np.asarray([0, S - 1, 0, S - 1], np.int64)
            return np.asarray([l, r, t, b], np.int64)

        return {
            "head_box": box_from("head_crop", self.head_crop_size),
            "left_hand_box": box_from("left_hand_crop", self.hand_crop_size),
            "right_hand_box": box_from("right_hand_crop", self.hand_crop_size),
        }


def build_dataset(cfg, split: str) -> TrackedVideoDataset:
    """Config-driven constructor (ref: dataset/__init__.py:1-5)."""
    return TrackedVideoDataset(
        data_path=cfg.DATASET.data_path,
        split=split,
        image_size=cfg.MODEL.image_size,
        feature_img_size=cfg.MODEL.feature_img_size,
        origin_image_size=cfg.DATASET.origin_image_size,
        head_crop_size=cfg.DATASET.head_crop_size,
        hand_crop_size=cfg.DATASET.hand_crop_size,
    )
