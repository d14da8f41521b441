"""The traffic generators repeat under a seed and keep their sizes across seeds."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness


def cells(generator):
    return [w["name"] for w in harness.load_manifest()["workloads"]
            if harness.find_cell(w["name"]).traffic["generator"] == generator]


@pytest.mark.parametrize("cell", cells("motion_walk"))
def test_same_seed_same_traffic(cell):
    c = harness.find_cell(cell)
    gen = c.generator()
    a = gen.generate(c.traffic, 2 ** 33 + 5, 50, 20)
    b = gen.generate(c.traffic, 2 ** 33 + 5, 50, 20)
    other = gen.generate(c.traffic, 11, 50, 20)
    assert len(a) == len(b) == len(other) == c.traffic["frames"]
    for x, y, z in zip(a, b, other):
        for k in x["params"]:
            np.testing.assert_array_equal(x["params"][k], y["params"][k])
            assert x["params"][k].shape == z["params"][k].shape
            assert x["params"][k].dtype == np.float32
    # another seed: the same set of frames, in another order
    key = [f["params"]["body_pose"].tobytes() for f in a]
    other_key = [f["params"]["body_pose"].tobytes() for f in other]
    assert sorted(key) == sorted(other_key) and key != other_key


def test_motion_walk_is_smooth_and_stationary():
    c = harness.find_cell("out2048.motion")
    frames = c.generator().generate(c.traffic, 123, 50, 20)
    body = np.stack([f["params"]["body_pose"] for f in frames])
    step = np.abs(np.diff(body, axis=0)).mean()
    assert step < 0.2 * body.std()
    assert 0.3 * c.traffic["body_pose_sd"] < body[50:].std() < 2.0 * c.traffic["body_pose_sd"]


def test_store_written_once_and_repeats(tmp_path, monkeypatch):
    import hashlib

    c = harness.find_cell("ubody512.train")
    gen = c.generator()
    traffic = dict(c.traffic, videos=1, frames_per_video=4, image_size=32, n_shape=8, n_exp=4)
    digests = []
    for sub in ("a", "b"):
        monkeypatch.setattr(gen, "ROOT", tmp_path / sub)
        path = gen.generate(traffic, seed=1)
        assert gen.generate(traffic, seed=2) == path            # the run's seed: no new store
        blob = (tmp_path / sub / "build" / "perfbench" / "data")
        assert [p.name for p in blob.iterdir()] == [path.rsplit("/", 1)[1]]
        digests.append(hashlib.sha256(open(f"{path}/img_store.grv", "rb").read()).hexdigest())
    assert digests[0] == digests[1]
    other = gen.store_dir(dict(traffic, store_seed=1))
    assert other != gen.store_dir(traffic)
