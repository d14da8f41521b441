"""The port's tracked-video data layer (`data/tracked.py`, `data/loader.py`,
`data/synthetic.py`) against the JAX package's: the same records, the same
batches and the same files from the same seeds."""

import filecmp
import json
import os
import pickle

import numpy as np
import pytest
import torch

from guava_renderer_tpu.data import loader as jloader
from guava_renderer_tpu.data import synthetic as jsynthetic
from guava_renderer_tpu.data import tracked as jtracked
from guava_renderer_tpu_torch.data import loader as ploader
from guava_renderer_tpu_torch.data import synthetic as psynthetic
from guava_renderer_tpu_torch.data import tracked as ptracked
from guava_renderer_tpu_torch.data.codec import decode_image
from guava_renderer_tpu_torch.data.store import RecordStore
from guava_renderer_tpu_torch.testing import tree_to_torch

META_FILES = ("optim_tracking_ehm.pkl", "id_share_params.pkl", "videos_info.json",
              "dataset_frames.json")
# (origin, image_size, feature_img_size): INTER_AREA's fractional downscale
# (micro), identity and upscale, and the integer box mean
SIZES = [(48, 32, 28), (64, 64, 70), (96, 48, 48)]


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), (path, float(np.abs(a.astype(float) - b).max()))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: "x".join(map(str, s)))
def jax_dataset(request, tmp_path_factory):
    origin, size, feat = request.param
    path = str(tmp_path_factory.mktemp("ds"))
    jsynthetic.write_synthetic_dataset(path, n_videos=2, n_frames=5, image_size=origin,
                                       n_shape=8, n_exp=4, image_mode="smooth")
    return path, dict(image_size=size, feature_img_size=feat, origin_image_size=origin)


@pytest.mark.parametrize("split,test_full", [("train", False), ("valid", False),
                                             ("test", False), ("test", True)])
def test_every_record_equals_jax(jax_dataset, split, test_full):
    path, kw = jax_dataset
    if split == "test":
        with open(os.path.join(path, "testing_split.json"), "w") as f:
            json.dump({"vid000": 2, "vid001": 3}, f)
    p = ptracked.TrackedVideoDataset(path, split, seed=0, test_full=test_full, **kw)
    j = jtracked.TrackedVideoDataset(path, split, seed=0, test_full=test_full, **kw)
    assert p.frames == j.frames and len(p) > 0
    for i in range(len(j)):                 # the source frame drawn from seed 0 included
        _equal(p[i], j[i], f"{split}[{i}]")
    assert p.store.backend == "native"


def test_source_choice_follows_the_seed(jax_dataset):
    path, kw = jax_dataset
    p = ptracked.TrackedVideoDataset(path, "train", seed=3, **kw)
    j = jtracked.TrackedVideoDataset(path, "train", seed=3, **kw)
    picks_p = [p._choose_source(*p.frames[i % len(p)].split("/")) for i in range(20)]
    picks_j = [j._choose_source(*j.frames[i % len(j)].split("/")) for i in range(20)]
    assert picks_p == picks_j and len(set(picks_p)) > 1


def test_build_dataset_reads_the_config(jax_dataset):
    from guava_renderer_tpu_torch.utils.config import ConfigDict

    path, kw = jax_dataset
    cfg = ConfigDict({"DATASET": {"data_path": path, "origin_image_size": kw["origin_image_size"],
                                  "head_crop_size": 24, "hand_crop_size": 24},
                      "MODEL": {"image_size": kw["image_size"],
                                "feature_img_size": kw["feature_img_size"]}})
    ds = ptracked.build_dataset(cfg, "valid")
    ref = jtracked.TrackedVideoDataset(path, "valid", head_crop_size=24, hand_crop_size=24, **kw)
    _equal(ds[1], ref[1])


def test_boxes_from_crop_homographies(tmp_path):
    path = str(tmp_path)
    jsynthetic.write_synthetic_dataset(path, n_videos=1, n_frames=3, image_size=48, n_shape=8,
                                       n_exp=4)
    with open(os.path.join(path, "optim_tracking_ehm.pkl"), "rb") as f:
        tracked = pickle.load(f)
    rng = np.random.default_rng(4)
    for i, rec in enumerate(tracked["vid000"].values()):
        rec["body_crop"] = {"M_o2c-hd": np.diag([2.0, 2.0, 1.0]).astype(np.float32)}
        for key in ("head_crop", "left_hand_crop", "right_hand_crop"):
            M = np.eye(3, dtype=np.float32)
            M[:2, :2] *= rng.uniform(0.2, 0.6)
            M[:2, 2] = rng.uniform(0, 20, 2)
            if i == 2 and key == "head_crop":
                M[:2, :2] = 0.0           # degenerate: falls back to the whole frame
            rec[key] = {"M_c2o": M}
    with open(os.path.join(path, "optim_tracking_ehm.pkl"), "wb") as f:
        pickle.dump(tracked, f)
    kw = dict(image_size=32, feature_img_size=28, origin_image_size=48, head_crop_size=24,
              hand_crop_size=24)
    p = ptracked.TrackedVideoDataset(path, "test", **kw)
    j = jtracked.TrackedVideoDataset(path, "test", **kw)
    boxes = []
    for fk, rec in tracked["vid000"].items():
        got, ref = p._boxes(rec), j._boxes(rec)
        _equal(got, ref)
        boxes.append(got["head_box"].tolist())
    assert boxes[2] == [0, 31, 0, 31] and boxes[0] != [0, 31, 0, 31]
    for i in range(len(j)):
        _equal(p[i], j[i])


@pytest.mark.parametrize("host_id,num_hosts,drop_last,shuffle",
                         [(0, 1, True, True), (1, 2, False, True), (0, 3, False, False)])
def test_loader_batches_equal_jax_over_two_epochs(jax_dataset, host_id, num_hosts, drop_last,
                                                  shuffle):
    path, kw = jax_dataset
    kw = dict(kw, seed=1)
    pl = ploader.PrefetchLoader(ptracked.TrackedVideoDataset(path, "train", **kw), 3,
                                shuffle=shuffle, host_id=host_id, num_hosts=num_hosts,
                                drop_last=drop_last)
    jl = jloader.PrefetchLoader(jtracked.TrackedVideoDataset(path, "train", **kw), 3,
                                shuffle=shuffle, host_id=host_id, num_hosts=num_hosts,
                                drop_last=drop_last)
    assert len(pl) == len(jl)
    for epoch in range(2):
        pb, jb = list(pl), list(jl)
        assert len(pb) == len(jb) > 0, epoch
        for a, b in zip(pb, jb):
            _equal(a, b, f"epoch {epoch}")
    first = next(iter(ploader.endless(ploader.PrefetchLoader(
        ptracked.TrackedVideoDataset(path, "valid", **kw), 2, shuffle=False))))
    assert first["target"]["image"].shape[0] == 2


def test_to_device_gives_the_dtypes_of_tree_to_torch(jax_dataset):
    path, kw = jax_dataset
    batch = next(iter(ploader.PrefetchLoader(ptracked.TrackedVideoDataset(path, "valid", **kw),
                                             2, shuffle=False)))
    got = ploader.to_device(batch, torch.device("cpu"))
    ref = tree_to_torch(batch, torch.device("cpu"))

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    walk(got, ref)
    assert got["target"]["boxes"]["head_box"].dtype == torch.int64
    # a loader that pins without a card makes plain tensors, which to_device passes on
    pinned = ploader.PrefetchLoader(ptracked.TrackedVideoDataset(path, "valid", **kw), 2,
                                    shuffle=False, pin_memory=True)
    walk(ploader.to_device(next(iter(pinned)), torch.device("cpu")), ref)
    assert ploader.DeviceBatches(pinned, torch.device("cpu")) is not None
    assert sum(1 for _ in ploader.DeviceBatches(pinned, torch.device("cpu"))) == len(pinned)
    # `last` is the batch handed out last, across the epochs that `endless` starts
    view = ploader.DeviceBatches(pinned, torch.device("cpu"))
    assert view.last is None
    for batch, _ in zip(ploader.endless(view), range(len(pinned) + 1)):
        assert view.last is batch


@pytest.mark.parametrize("image_mode,frozen", [("noise", False), ("smooth", False),
                                               ("smooth", True), ("noise", True)])
def test_synthetic_writer_equals_jax(tmp_path, image_mode, frozen):
    kw = dict(n_videos=2, n_frames=4, image_size=40, n_shape=8, n_exp=4, seed=3,
              image_mode=image_mode, frozen_motion=frozen)
    psynthetic.write_synthetic_dataset(str(tmp_path / "p"), **kw)
    jsynthetic.write_synthetic_dataset(str(tmp_path / "j"), **kw)
    for name in META_FILES:
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name, shallow=False), name
    ps, js = RecordStore(str(tmp_path / "p" / "img_store.grv")), \
        RecordStore(str(tmp_path / "j" / "img_store.grv"))
    assert sorted(ps.keys()) == sorted(js.keys())
    for k in js.keys():
        if k.endswith("body_image"):        # the encoder writes OpenCV's bytes
            assert ps.get(k) == js.get(k), k
        assert np.array_equal(decode_image(ps.get(k)), decode_image(js.get(k))), k
