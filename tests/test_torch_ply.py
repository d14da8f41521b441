"""The port's PLY export against the JAX package's: the same bytes."""

import numpy as np
import pytest

from guava_renderer_tpu.utils import ply as jply
from guava_renderer_tpu_torch.utils import ply as tply


@pytest.fixture
def gaussians():
    rng = np.random.default_rng(0)
    P = 37
    return dict(xyz=rng.normal(size=(P, 3)).astype(np.float32),
                rgb=rng.uniform(0, 1, (P, 3)).astype(np.float32),
                opacity=rng.uniform(0, 1, (P, 1)).astype(np.float32),
                scales=rng.uniform(1e-3, 0.1, (P, 3)).astype(np.float32),
                rotations=rng.normal(size=(P, 4)).astype(np.float32))


def test_gaussian_ply_bytes_equal_and_round_trip(gaussians, tmp_path):
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), **gaussians)
    tply.save_gaussian_ply(str(tmp_path / "t.ply"), **gaussians)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tply.load_gaussian_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(back["x"], gaussians["xyz"][:, 0])
    np.testing.assert_allclose(np.exp(back["scale_1"]), gaussians["scales"][:, 1], rtol=1e-6)
    np.testing.assert_allclose(back["f_dc_2"] * tply.SH_C0 + 0.5, gaussians["rgb"][:, 2],
                               atol=1e-6)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_point_ply_bytes_equal(gaussians, tmp_path, with_rgb):
    rgb = gaussians["rgb"] if with_rgb else None
    jply.save_point_ply(str(tmp_path / "j.ply"), gaussians["xyz"], rgb)
    tply.save_point_ply(str(tmp_path / "t.ply"), gaussians["xyz"], rgb)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
