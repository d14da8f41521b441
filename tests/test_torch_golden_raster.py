"""The port's rasterizer against the committed golden render
(tests/golden/raster_scene_v1.npz, the dense-oracle image that the JAX
`rasterize` is held to in tests/test_golden_regression.py), at the same
tolerances: tile 16, radii equal, color and invdepth within atol 2e-5.

Run on the default path (K1's plain version here) and on size_classes +
vmem_classes with a ladder that makes half the Gaussians resident (K7's
plain version on the table that K9's plain version gathers).
"""

import os

import numpy as np
import pytest
import torch

from guava_renderer_tpu_torch.core.cameras import Camera
from guava_renderer_tpu_torch.kernels import gather_rows as k9
from guava_renderer_tpu_torch.ops import gsplat as tgs

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "raster_scene_v1.npz")
ATOL = 2e-5
# tile 16 at 64^2: 16 tiles, so a cap of 16 truncates nothing; the first two
# classes, 48 of the scene's 96 Gaussians, are resident
LADDER = ((16, 16), (32, 16), (48, 16))
SETTINGS = {"default": tgs.RasterizeSettings(tile=16),
            "resident": tgs.RasterizeSettings(tile=16, size_classes=LADDER, vmem_classes=2)}


def golden_inputs():
    s = np.load(GOLDEN)
    tf = torch.tensor(float(s["tanfov"]), dtype=torch.float32)
    n = int(s["size"])
    cam = Camera(R=torch.eye(3), t=torch.zeros(3), tanfovx=tf, tanfovy=tf, width=n, height=n)
    args = [torch.as_tensor(s[k]) for k in ("means", "colors", "opacity", "scales", "quats")]
    return s, args, cam


@pytest.mark.parametrize("path", sorted(SETTINGS))
def test_rasterize_matches_committed_golden(path, monkeypatch):
    s, args, cam = golden_inputs()
    gathered = []
    real = tgs.gather_resident

    def counted(rows, keys, id_bits):
        gathered.append(keys.shape[0])
        return real(rows, keys, id_bits)

    monkeypatch.setattr(tgs, "gather_resident", counted)
    color, radii, invd = tgs.rasterize(*args, cam, torch.as_tensor(s["bg"]), SETTINGS[path])
    np.testing.assert_array_equal(radii.numpy(), s["radii"])
    np.testing.assert_allclose(color.numpy(), s["color"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(invd.numpy(), s["invdepth"], atol=ATOL, rtol=0)
    assert gathered == ([] if path == "default" else [48])


def test_golden_resident_table_is_used():
    """The resident path's ladder keeps rows resident that the scene's
    tiles read: some instances are remapped into the table."""
    s, args, cam = golden_inputs()
    st = SETTINGS["resident"]
    prep = tgs.rasterize_prep(*args, cam, tgs.RasterizeSettings(tile=16))
    proj = tgs.project_gaussians(args[0], args[3], args[4], args[2], cam)
    P = args[0].shape[0]
    L = tgs.resident_count(st, P)
    lids = tgs.resident_ids(proj, cam.width, cam.height, 16, L)
    order = tgs.remap_resident(prep.order, lids, P)
    n_resident = int((order >= P).sum())
    assert L == 48 and 0 < n_resident < order.numel()
    assert torch.equal(k9.gather_rows(prep.rows.detach(), lids),
                       prep.rows.detach().index_select(0, lids.long()))
