"""Port vs JAX: the plain K5 and the host side of the mesh z-buffer against
`rasterize_mesh` (Pallas in interpret mode) on the analytic scenes of
tests/test_meshraster.py, the committed golden scene and an exact-tie
scene; then `visible_faces_mask`, `interpolate_attributes` and the mesh
previews. face_idx must be EQUAL; depth and bary agree to 2e-5 (the same
float32 edge functions; projection differs in the last ulp).

Every scene keeps each face within 32 tiles (asserted), where the JAX
package's duplication cap truncates nothing and both packages walk a tile's
faces in the same ascending order.

Then K5's redesigned walk through its plain model,
`mesh_zbuffer_split_plain` (segments, the exact cull, the 64-bit key
merge): bit-equal to `mesh_zbuffer_plain` on these scenes and on the edge
scenes of `testing.zbuffer_scenes` (collinear and near-degenerate faces,
slivers, equal depths across segment boundaries, a run many times the
segment, empty tiles) at tiles 8, 16 and 32, and through `rasterize_mesh`
equal to the JAX `rasterize_mesh`; the cull's rules against the plain
predicate on random pairs and boxes, degenerate ones included.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops import mesh_preview as jpreview
from guava_renderer_tpu.ops import meshraster as jmesh
from guava_renderer_tpu_torch import testing
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


# ---- K5's split walk: segments, the exact cull, the key merge ----

SEGMENTS = (1, 3, k5.SEGMENT)
TILES = (8, 16, 32)
EDGE_SIZE = 64       # the edge scenes against the plain version
JAX_SIZE = 32        # and against JAX: pixel steps of 2^-20 project exactly at 32^2


def _plain_and_split(bins, size, tile, segment):
    args = (bins.tris, bins.inst_fid, bins.ranges, size, size, tile)
    return k5.mesh_zbuffer_plain(*args), k5.mesh_zbuffer_split_plain(*args, segment)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    # bit for bit: the same float32 operations in the same order
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), want[1].numpy().view(np.int32))


@pytest.mark.parametrize("name,tile,segment", [
    (name, tile, segment) for name in SCENES for tile in TILES for segment in SEGMENTS
    if _scene(name)[2] % tile == 0])
def test_split_walk_equals_plain_on_scenes(name, tile, segment):
    verts, faces, size, tanfov = _scene(name)
    _, tcam = _cams(size, tanfov)
    bins = tmesh.bin_mesh(torch.tensor(verts), torch.tensor(faces), tcam, tile)
    want, got = _plain_and_split(bins, size, tile, segment)
    _assert_same(got, want)


@pytest.fixture(scope="module")
def edge_scenes():
    return testing.zbuffer_scenes(EDGE_SIZE, k5.SEGMENT)


def _edge_bins(scenes, name, size, tile):
    tri, tri_z = scenes[name]
    return tmesh.bin_triangles(torch.tensor(tri), torch.tensor(tri_z), size, size, tile)


EDGE_NAMES = ("collinear_rows", "collinear_diagonal", "near_degenerate", "slivers",
              "tie_segments", "deep_tile")


@pytest.mark.parametrize("segment", (1, 16, k5.SEGMENT))
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_split_walk_equals_plain_on_edge_scenes(edge_scenes, name, tile, segment):
    bins = _edge_bins(edge_scenes, name, EDGE_SIZE, tile)
    stats = {}
    args = (bins.tris, bins.inst_fid, bins.ranges, EDGE_SIZE, EDGE_SIZE, tile)
    want = k5.mesh_zbuffer_plain(*args)
    _assert_same(k5.mesh_zbuffer_split_plain(*args, segment, stats=stats), want)
    assert stats["pairs_divided"] <= stats["pairs_walked"] \
        <= 32 * stats["warp_pairs_walked"] <= 32 * stats["warp_pairs"]
    assert stats["warp_pairs_walked"] < stats["warp_pairs"], "the cull skipped nothing"


def _det(tri):
    t = torch.as_tensor(tri)
    return (t[:, 1, 0] - t[:, 0, 0]) * (t[:, 2, 1] - t[:, 0, 1]) \
        - (t[:, 1, 1] - t[:, 0, 1]) * (t[:, 2, 0] - t[:, 0, 0])


def test_edge_scenes_hold_their_cases(edge_scenes):
    """Each scene holds what it is named for, so the equalities above test it."""
    det = _det(edge_scenes["near_degenerate"][0])
    tiny = (det != 0) & (det.abs() < 1e-12)
    assert int((tiny & (det > 0)).sum()) >= 2 and int((tiny & (det < 0)).sum()) >= 2
    assert int((det == 0).sum()) >= 2
    # a det = 0 face owns pixels outside its bounding box: a box cull would drop them
    for name in ("collinear_rows", "collinear_diagonal"):
        tri, _ = edge_scenes[name]
        bins = _edge_bins(edge_scenes, name, EDGE_SIZE, 16)
        best, _ = k5.mesh_zbuffer_plain(bins.tris, bins.inst_fid, bins.ranges, EDGE_SIZE,
                                        EDGE_SIZE, 16)
        face = torch.where(best >= 0, bins.inst_fid[best.clamp(min=0).long()], -1)
        flat = _det(tri) == 0
        ys, xs = torch.nonzero((face >= 0) & flat[face.clamp(min=0).long()], as_tuple=True)
        f = face[ys, xs].long()
        lo, hi = bins.tri[f].amin(1), bins.tri[f].amax(1)
        outside = (xs < lo[:, 0]) | (xs > hi[:, 0]) | (ys < lo[:, 1]) | (ys > hi[:, 1])
        assert int(outside.sum()) > 0, name
    # the nearest copies straddle the first segment boundary: the lowest wins
    bins = _edge_bins(edge_scenes, "tie_segments", EDGE_SIZE, 16)
    best, depth = k5.mesh_zbuffer_plain(bins.tris, bins.inst_fid, bins.ranges, EDGE_SIZE,
                                        EDGE_SIZE, 16)
    assert int(bins.ranges[0]) == 0 and int(best[3, 3]) == k5.SEGMENT - 2
    assert float(depth[3, 3]) == pytest.approx(2.0, abs=1e-6)
    runs = bins.ranges[1:] - bins.ranges[:-1]
    assert int(runs.max()) >= 3 * k5.SEGMENT
    bins = _edge_bins(edge_scenes, "deep_tile", EDGE_SIZE, 16)
    assert int((bins.ranges[1:] - bins.ranges[:-1]).max()) >= 6 * k5.SEGMENT
    bins = _edge_bins(edge_scenes, "near_degenerate", EDGE_SIZE, 16)
    assert int((bins.ranges[1:] == bins.ranges[:-1]).sum()) > 0, "no empty tile"


@pytest.fixture(scope="module")
def jax_edge():
    # identity pose and tanfov 1: testing.pixels_to_world inverts this projection exactly
    jcam, tcam = _cams(JAX_SIZE, 1.0)
    return testing.zbuffer_scenes(JAX_SIZE, k5.SEGMENT), tcam, jcam


# Faces on a pixel diagonal stay out (ROADMAP.md §3: XLA's FMA contraction on the CPU
# decides other pixels there). So do the near-degenerate faces at tiles 16 and 32: each of
# their quotients is ~1e6 times their barycentric range, and at pixels 8 or more from
# them the contraction moves w2 past 0 (2 and 34 pixels differ from JAX at those tiles);
# the equalities with the plain version above hold them there.
JAX_CASES = [(name, tile) for name in ("collinear_rows", "slivers", "tie_segments", "deep_tile")
             for tile in TILES] + [("near_degenerate", 8)]


@pytest.mark.parametrize("name,tile", JAX_CASES)
def test_split_walk_through_rasterize_mesh_vs_jax(jax_edge, monkeypatch, name, tile):
    scenes, tcam, jcam = jax_edge
    tri, tri_z = scenes[name]
    verts, faces = testing.pixels_to_world(tri, tri_z, JAX_SIZE)
    pix, _ = project_points(tcam, torch.tensor(verts))
    np.testing.assert_array_equal(pix.numpy().reshape(-1, 3, 2), tri)    # the camera is exact
    want = jmesh.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jcam, tile=tile)
    monkeypatch.setattr(tmesh, "mesh_zbuffer", k5.mesh_zbuffer_split_plain)
    got = tmesh.rasterize_mesh(torch.tensor(verts), torch.tensor(faces), tcam, tile=tile)
    np.testing.assert_array_equal(got.face_idx.numpy(), np.asarray(want.face_idx))
    hit = np.asarray(want.face_idx) >= 0
    np.testing.assert_array_equal(np.isinf(got.depth.numpy()), ~hit)
    np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(want.depth)[hit], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary), atol=ATOL, rtol=0)


def _random_triangles(rng, n, kind):
    """(n, 12) f32 triangle rows of one kind of trouble for the cull."""
    if kind == "spread":
        p = rng.uniform(-50, 600, (n, 3, 2))
    elif kind == "slivers":
        a = rng.uniform(0, 512, (n, 1, 2))
        d = rng.normal(size=(n, 1, 2))
        along = rng.uniform(-300, 300, (n, 3, 1)) * d
        p = a + along + rng.normal(size=(n, 3, 2)) * 10.0 ** rng.uniform(-7, -1, (n, 1, 1))
    elif kind == "tiny":
        p = rng.integers(0, 100, (n, 3, 2)) * 2.0 ** -20 + rng.integers(0, 3, (n, 1, 2))
    elif kind == "collinear":
        a = rng.integers(0, 64, (n, 1, 2))
        d = rng.integers(-3, 4, (n, 1, 2))
        p = a + rng.integers(-4, 5, (n, 3, 1)) * d
    else:   # huge: products near float's range
        p = rng.uniform(-1, 1, (n, 3, 2)) * 10.0 ** rng.uniform(3, 19, (n, 1, 1))
    t = np.zeros((n, 3, 4), np.float32)
    t[..., :2] = p
    t[..., 2] = rng.uniform(0.5, 4, (n, 3))
    return torch.as_tensor(t.reshape(n, 12))


def _plain_inside(t, px, py):
    d, _, _, _ = k5.cull_constants(t)
    e0, e1 = k5.edge_functions(t, px, py)
    w0, w1 = e0 / d, e1 / d
    w2 = 1.0 - w0 - w1
    return (w0 >= k5.EDGE_EPS) & (w1 >= k5.EDGE_EPS) & (w2 >= k5.EDGE_EPS)


@pytest.mark.parametrize("kind", ("spread", "slivers", "tiny", "collinear", "huge"))
def test_pair_rules_never_reject_a_hit(kind):
    """R1-R3 reject only pixels the plain predicate rejects (and most of the
    others, or they would be worth nothing)."""
    rng = np.random.default_rng(["spread", "slivers", "tiny", "collinear", "huge"].index(kind))
    t = _random_triangles(rng, 4000, kind)
    centre = t[:, [0, 1]] if kind in ("tiny", "collinear") else torch.zeros((4000, 2))
    px = (centre[:, 0:1].round() + torch.as_tensor(rng.integers(-40, 41, (4000, 64)))).float()
    py = (centre[:, 1:2].round() + torch.as_tensor(rng.integers(-40, 41, (4000, 64)))).float()
    if kind in ("spread", "slivers", "huge"):
        px = px + torch.as_tensor(rng.integers(0, 512, (4000, 1))).float()
        py = py + torch.as_tensor(rng.integers(0, 512, (4000, 1))).float()
    _, s, tau, sum_min = k5.cull_constants(t)
    e0, e1 = k5.edge_functions(t, px, py)
    rejected = k5.pair_rejects(e0, e1, s, tau, sum_min)
    inside = _plain_inside(t, px, py)
    assert not bool((rejected & inside).any())
    assert int(inside.sum()) > 0
    assert float(rejected.float().mean()) > 0.3


@pytest.mark.parametrize("kind", ("spread", "slivers", "tiny", "collinear", "huge"))
def test_box_rules_never_reject_a_hit(kind):
    """A triangle the warp test skips covers no pixel of the warp's 8 x 4
    box under the plain predicate; the test skips most far boxes."""
    rng = np.random.default_rng(10 + ["spread", "slivers", "tiny", "collinear", "huge"].index(kind))
    n = 3000
    t = _random_triangles(rng, n, kind)
    anchor = t[:, [0, 1]].round() if kind in ("tiny", "collinear") else \
        torch.as_tensor(rng.integers(0, 512, (n, 2))).float()
    x0 = anchor[:, 0:1] + torch.as_tensor(rng.integers(-24, 17, (n, 1))).float()
    y0 = anchor[:, 1:2] + torch.as_tensor(rng.integers(-12, 9, (n, 1))).float()
    _, s, tau, sum_min = k5.cull_constants(t)
    skipped = k5.box_rejects(t, s, tau, sum_min, x0 + 3.5, y0 + 1.5, 3.5, 1.5)
    lane = torch.arange(32)
    px, py = x0 + (lane % 8).float(), y0 + (lane // 8).float()
    inside = _plain_inside(t, px, py)
    assert not bool((skipped[:, 0] & inside.any(1)).any())
    assert float(skipped.float().mean()) > 0.2


@pytest.mark.parametrize("tile", (8, 12, 16, 24, 32))
def test_cta_layout_covers_the_tile(tile):
    lx, ly, has, cx, cy, hx, hy = k5.cta_layout(tile)
    pixels = (ly * tile + lx)[has]
    assert sorted(pixels.tolist()) == list(range(tile * tile))
    warp = torch.arange(lx.shape[0]) // 32
    inside = ((lx - cx[warp]).abs() <= hx) & ((ly - cy[warp]).abs() <= hy)
    assert bool(inside[has].all())


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("tile", TILES)
def test_slack_around_the_runs_is_read_by_no_tile(edge_scenes, tile, segment):
    """inst_fid may hold instances outside ranges[0]:ranges[n_tiles]: padded
    with tile 0's own run on both sides (ties at lower instances, were they
    walked as tile 0's), both plain versions give the unpadded images, with
    every instance index shifted by the front's length."""
    bins = _edge_bins(edge_scenes, "tie_segments", EDGE_SIZE, tile)
    args = (EDGE_SIZE, EDGE_SIZE, tile)
    want_best, want_depth = k5.mesh_zbuffer_plain(bins.tris, bins.inst_fid, bins.ranges, *args)
    run0 = bins.inst_fid[int(bins.ranges[0]):int(bins.ranges[1])]
    inst, ranges = testing.pad_instances(bins.inst_fid, bins.ranges, run0, run0[:segment + 3])
    shifted = torch.where(want_best >= 0, want_best + run0.shape[0], -1)
    for fn in (k5.mesh_zbuffer_plain, k5.mesh_zbuffer_split_plain):
        _assert_same(fn(bins.tris, inst, ranges, *args), (shifted, want_depth))
