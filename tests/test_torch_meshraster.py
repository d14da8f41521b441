"""Port vs JAX: the plain K5 and the host side of the mesh z-buffer against
`rasterize_mesh` (Pallas in interpret mode) on the analytic scenes of
tests/test_meshraster.py, the committed golden scene and an exact-tie
scene; then `visible_faces_mask`, `interpolate_attributes` and the mesh
previews. face_idx must be EQUAL; depth and bary agree to 2e-5 (the same
float32 edge functions; projection differs in the last ulp).

Every scene keeps each face within 32 tiles (asserted), where the JAX
package's duplication cap truncates nothing and both packages walk a tile's
faces in the same ascending order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops import mesh_preview as jpreview
from guava_renderer_tpu.ops import meshraster as jmesh
from guava_renderer_tpu_torch.core.cameras import Camera as TCamera
from guava_renderer_tpu_torch.core.cameras import project_points
from guava_renderer_tpu_torch.kernels import meshraster as k5
from guava_renderer_tpu_torch.ops import mesh_preview as tpreview
from guava_renderer_tpu_torch.ops import meshraster as tmesh

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "meshraster_scene_v1.npz")
ATOL = 2e-5


def _cams(size, tanfov=0.5):
    jcam = JCamera(R=jnp.eye(3), t=jnp.zeros(3), tanfovx=jnp.asarray(tanfov),
                   tanfovy=jnp.asarray(tanfov), width=size, height=size)
    tcam = TCamera(R=torch.eye(3), t=torch.zeros(3), tanfovx=torch.tensor(tanfov),
                   tanfovy=torch.tensor(tanfov), width=size, height=size)
    return jcam, tcam


def _random_mesh(seed, V=30, F=24):
    rng = np.random.default_rng(seed)
    verts = np.zeros((V, 3), np.float32)
    verts[:, 0] = rng.uniform(-0.7, 0.7, V)
    verts[:, 1] = rng.uniform(-0.7, 0.7, V)
    verts[:, 2] = rng.uniform(1.5, 4.0, V)
    return verts, rng.integers(0, V, (F, 3)).astype(np.int32)


def _scene(name):
    """-> (verts (V, 3) f32, faces (F, 3) i32, image size, tanfov)."""
    if name == "single":
        return (np.array([[-0.8, -0.8, 2.0], [0.8, -0.8, 2.0], [0.0, 0.9, 2.0]], np.float32),
                np.array([[0, 1, 2]], np.int32), 32, 0.5)
    if name == "occlusion":
        v = np.array([[-0.8, -0.8, 4.0], [0.8, -0.8, 4.0], [0.0, 0.9, 4.0],
                      [-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.25, 2.0]], np.float32)
        return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32), 32, 0.5
    if name == "behind":
        return (np.array([[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.5, -2.0]], np.float32),
                np.array([[0, 1, 2]], np.int32), 16, 0.5)
    if name == "offscreen":
        # one face far outside the image, one crossing its left border, one
        # crossing the top border with a vertex nearer than the cull plane's
        # neighbourhood (z = 0.05 > 0.01 stays valid)
        v = np.array([[5.0, 5.0, 2.0], [6.0, 5.0, 2.0], [5.5, 6.0, 2.0],
                      [-2.0, -0.3, 3.0], [0.4, -0.5, 3.0], [0.2, 0.6, 3.0],
                      [0.3, -2.5, 2.5], [0.9, -0.2, 2.5], [0.02, 0.01, 0.05]], np.float32)
        return v, np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32), 32, 0.5
    if name == "random":
        return _random_mesh(0) + (32, 0.5)
    if name == "random64":
        return _random_mesh(5, V=60, F=80) + (64, 0.5)
    if name == "tie":
        # the same triangle three times at one depth, then a nearer copy and a
        # duplicate of it: the lowest face id of the nearest depth must win
        tri = np.array([[-0.7, -0.6, 2.0], [0.7, -0.6, 2.0], [0.0, 0.8, 2.0]], np.float32)
        near = tri * np.array([0.5, 0.5, 0.75], np.float32)
        v = np.concatenate([tri, tri, tri, near, near])
        return v, np.arange(15, dtype=np.int32).reshape(5, 3), 32, 0.5
    if name == "golden":
        s = np.load(GOLDEN)
        return s["verts"], s["faces"], int(s["size"]), float(s["tanfov"])
    raise KeyError(name)


SCENES = ["single", "occlusion", "behind", "offscreen", "random", "random64", "tie", "golden"]


@pytest.fixture(scope="module")
def rendered():
    cache = {}

    def get(name):
        if name not in cache:
            verts, faces, size, tanfov = _scene(name)
            jcam, tcam = _cams(size, tanfov)
            want = jmesh.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jcam)
            got = tmesh.rasterize_mesh(torch.tensor(verts), torch.tensor(faces), tcam)
            bins = tmesh.bin_mesh(torch.tensor(verts), torch.tensor(faces), tcam)
            cache[name] = (got, want, bins)
        return cache[name]

    return get


@pytest.mark.parametrize("name", SCENES)
def test_face_idx_equal_to_jax(rendered, name):
    got, want, bins = rendered(name)
    assert int(bins.tiles_per_face.max()) <= 32, "scene must stay under the JAX duplication cap"
    assert got.face_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.face_idx.numpy(), np.asarray(want.face_idx))


@pytest.mark.parametrize("name", SCENES)
def test_depth_and_bary_vs_jax(rendered, name):
    got, want, _ = rendered(name)
    hit = np.asarray(want.face_idx) >= 0
    np.testing.assert_array_equal(np.isinf(got.depth.numpy()), ~hit)
    np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(want.depth)[hit],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary), atol=ATOL, rtol=0)


def test_golden_scene_matches_committed_arrays(rendered):
    got, _, _ = rendered("golden")
    s = np.load(GOLDEN)
    np.testing.assert_array_equal(got.face_idx.numpy(), s["face_idx"])
    np.testing.assert_allclose(got.bary.numpy(), s["bary"], atol=ATOL)
    np.testing.assert_allclose(got.depth.numpy(), s["depth"], atol=ATOL)


def test_analytic_values(rendered):
    got, _, _ = rendered("single")
    assert int(got.face_idx[16, 16]) == 0 and int(got.face_idx[0, 0]) == -1
    assert float(got.depth[16, 16]) == pytest.approx(2.0, abs=1e-4)
    assert np.isinf(float(got.depth[0, 0]))
    got, _, _ = rendered("occlusion")
    assert int(got.face_idx[16, 16]) == 1 and int(got.face_idx[12, 11]) == 0
    got, _, bins = rendered("behind")
    assert int((got.face_idx >= 0).sum()) == 0 and bins.inst_fid.numel() == 0


def test_tie_goes_to_lowest_face(rendered):
    got, _, _ = rendered("tie")
    ids = set(np.unique(got.face_idx.numpy()).tolist())
    assert ids == {-1, 0, 3}, ids
    assert int(got.face_idx[16, 16]) == 3
    assert float(got.depth[16, 16]) == pytest.approx(1.5, abs=1e-5)


@pytest.mark.parametrize("name", ["random", "golden"])
def test_binning_is_tile_grouped_and_face_ascending(rendered, name):
    _, _, bins = rendered(name)
    ranges, fid = bins.ranges.numpy(), bins.inst_fid.numpy()
    assert ranges[0] == 0 and ranges[-1] == len(fid) == int(bins.tiles_per_face.sum())
    assert (np.diff(ranges) >= 0).all()
    for t in range(len(ranges) - 1):
        run = fid[ranges[t]:ranges[t + 1]]
        assert (np.diff(run) > 0).all(), f"tile {t} not strictly ascending"
    assert bins.tris.shape == (bins.tri.shape[0], 12)
    assert float(bins.tris[:, 3::4].abs().max()) == 0.0


def test_plain_zbuffer_against_dense_oracle():
    """The plain K5 against a per-face loop over all pixels in float64 (the
    oracle of tests/test_meshraster.py): > 99.5% of pixels agree, the rest
    being float32 edge cases."""
    verts, faces = _random_mesh(0)
    _, tcam = _cams(32)
    res = tmesh.rasterize_mesh(torch.tensor(verts), torch.tensor(faces), tcam)
    pix, z = project_points(tcam, torch.tensor(verts))
    pix, z = pix.numpy(), z.numpy()
    best = np.full((32, 32), -1, np.int64)
    bz = np.full((32, 32), np.inf)
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float64)
    for f in range(len(faces)):
        a, b, c = pix[faces[f]]
        za, zb, zc = z[faces[f]]
        det = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(det) < 1e-12:
            det = 1e-12
        w0 = ((b[0] - xs) * (c[1] - ys) - (b[1] - ys) * (c[0] - xs)) / det
        w1 = ((c[0] - xs) * (a[1] - ys) - (c[1] - ys) * (a[0] - xs)) / det
        w2 = 1 - w0 - w1
        zi = w0 * za + w1 * zb + w2 * zc
        upd = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6) & (zi > 0) & (zi < bz)
        best[upd] = f
        bz[upd] = zi[upd]
    assert (res.face_idx.numpy() == best).mean() > 0.995


def test_wrapper_validates_and_counts_no_cpu_launch():
    tris = torch.zeros((1, 12))
    fid = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(5, dtype=torch.int32)
    before = k5.launches
    best, depth = k5.mesh_zbuffer(tris, fid, ranges, 32, 32, 16)
    assert k5.launches == before, "the CPU path runs the plain version, not a launch"
    assert best.shape == depth.shape == (32, 32) and int(best.max()) == -1
    with pytest.raises(ValueError, match="tile"):
        k5.mesh_zbuffer(tris, fid, ranges, 30, 32, 16)
    with pytest.raises(ValueError, match="tris"):
        k5.mesh_zbuffer(torch.zeros((1, 9)), fid, ranges, 32, 32, 16)
    with pytest.raises(ValueError, match="inst_fid"):
        k5.mesh_zbuffer(tris, fid.long(), ranges, 32, 32, 16)
    with pytest.raises(ValueError, match="ranges"):
        k5.mesh_zbuffer(tris, fid, ranges[:4], 32, 32, 16)


@pytest.mark.parametrize("name", ["occlusion", "random", "behind"])
def test_visible_faces_mask_vs_jax(rendered, name):
    got, want, _ = rendered(name)
    F = _scene(name)[1].shape[0]
    np.testing.assert_array_equal(tmesh.visible_faces_mask(got.face_idx, F).numpy(),
                                  np.asarray(jmesh.visible_faces_mask(want.face_idx, F)))


@pytest.mark.parametrize("name", ["single", "random"])
def test_interpolate_attributes_vs_jax(rendered, name):
    got, want, _ = rendered(name)
    verts, faces, _, _ = _scene(name)
    attrs = np.concatenate([verts, np.cos(verts[:, :2])], axis=1)
    w = jmesh.interpolate_attributes(want, jnp.asarray(faces), jnp.asarray(attrs))
    g = tmesh.interpolate_attributes(got, torch.tensor(faces), torch.tensor(attrs))
    assert g.shape == (32, 32, 5)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_mesh_previews_vs_jax():
    """atol 1e-4: interpolated values of O(1) through bary at 2e-5."""
    verts, faces, size, _ = _scene("occlusion")
    jcam, tcam = _cams(size)
    rng = np.random.default_rng(4)
    texcoords = rng.uniform(0.05, 0.95, (6, 2)).astype(np.float32)
    texture = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    jrgb, jalpha = jpreview.render_textured_mesh(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(faces), jnp.asarray(texcoords),
        jnp.asarray(texture), jcam)
    trgb, talpha = tpreview.render_textured_mesh(
        torch.tensor(verts), torch.tensor(faces), torch.tensor(faces), torch.tensor(texcoords),
        torch.tensor(texture), tcam)
    np.testing.assert_array_equal(talpha.numpy(), np.asarray(jalpha))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=1e-4, rtol=0)

    jimg, jalpha2 = jpreview.render_mesh_attributes(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(verts), jcam)
    timg, talpha2 = tpreview.render_mesh_attributes(
        torch.tensor(verts), torch.tensor(faces), torch.tensor(verts), tcam)
    np.testing.assert_array_equal(talpha2.numpy(), np.asarray(jalpha2))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-4, rtol=0)
