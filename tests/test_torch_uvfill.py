"""The port's UV chart fill (`bodymodel/data.py:uv_face_tables`) against
OpenCV's, which the JAX package's `uv_face_tables` uses by default.

Every texel of the face-id map is held equal to a `cv2.drawContours(img,
[tri], 0, f, -1)` loop over the faces in order, on random triangle sets at
U = 16, 64 and 512 (degenerate, collinear, sliver, off-chart and
overlapping faces among them), and to the JAX function on the synthetic
rigs at 64 and 512; the barycentrics within 1e-6 where the ids agree. The
line pixels (`_line_pixels`) are held to `cv2.line` on their own.
"""

import cv2
import numpy as np
import pytest

from guava_renderer_tpu.bodymodel import data as jdata
from guava_renderer_tpu.bodymodel import synthetic as jsyn
from guava_renderer_tpu_torch.bodymodel import data as tdata
from guava_renderer_tpu_torch.bodymodel import synthetic as tsyn

BARY_ATOL = 1e-6
KINDS = ("inside", "border", "off_chart", "collinear", "degenerate", "sliver", "overlapping",
         "tiny")


def _corners(kind: str, U: int, F: int, rng: np.random.Generator) -> np.ndarray:
    """(F, 3, 2) integer triangle corners of one kind."""
    if kind == "inside":
        return rng.integers(0, U, (F, 3, 2))
    if kind == "border":                       # corners on [0, U]: U lies off the image
        return rng.integers(0, U + 1, (F, 3, 2))
    if kind == "off_chart":
        return rng.integers(-U // 2, U + U // 2, (F, 3, 2))
    if kind == "collinear":
        p, q = rng.integers(-2, U + 2, (2, F, 2))
        k = rng.integers(-2, 3, (F, 1))
        return np.stack([p, q, p + (q - p) * k], 1)
    if kind == "degenerate":                   # repeated corners, horizontal and vertical runs
        t = rng.integers(0, U + 1, (F, 3, 2))
        t[0::3, 1] = t[0::3, 0]
        t[1::3, :, 1] = t[1::3, :1, 1]
        t[2::3, :, 0] = t[2::3, :1, 0]
        return t
    if kind == "sliver":
        p = rng.integers(0, U, (F, 2))
        d = rng.integers(-U // 2, U // 2 + 1, (F, 2))
        e = rng.integers(-1, 2, (F, 2))
        return np.stack([p, p + d, p + d + e], 1)
    if kind == "overlapping":                  # large faces over one region
        c = rng.integers(U // 4, 3 * U // 4, (F, 1, 2))
        return c + rng.integers(-U // 3, U // 3 + 1, (F, 3, 2))
    if kind == "tiny":                         # a real chart's texel-sized faces
        c = rng.integers(0, U, (F, 1, 2))
        return c + rng.integers(0, 3, (F, 3, 2))
    raise ValueError(kind)


def _cv2_fill(tri: np.ndarray, U: int) -> np.ndarray:
    img = np.full((U, U), -1, np.int32)
    for f in range(len(tri)):
        cv2.drawContours(img, [tri[f].astype(np.int32)], 0, int(f), -1)
    return img


def _as_chart(tri: np.ndarray, U: int) -> tuple[np.ndarray, np.ndarray]:
    """Texcoords whose round(t * U) are the given corners (exact: U is a power of two)."""
    tex = (tri.reshape(-1, 2) / U).astype(np.float32)
    assert np.array_equal(np.round(tex * U).astype(np.int64), tri.reshape(-1, 2))
    return tex, np.arange(tex.shape[0], dtype=np.int32).reshape(-1, 3)


@pytest.mark.parametrize("U", [16, 64, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_fill_equals_cv2(U, kind):
    rng = np.random.default_rng(U * 31 + KINDS.index(kind))
    F = {16: 400, 64: 600, 512: 300}[U]
    tri = _corners(kind, U, F, rng)
    tex, fvt = _as_chart(tri, U)
    face_idx, bary, mask = tdata.uv_face_tables(tex, fvt, U)
    want = _cv2_fill(tri, U)
    assert (face_idx != want).sum() == 0, f"{int((face_idx != want).sum())} texels differ"
    np.testing.assert_array_equal(mask, want >= 0)
    assert bary.dtype == np.float32 and float(bary[~mask].max(initial=0.0)) == 0.0


@pytest.mark.parametrize("U", [16, 64, 512])
def test_tables_equal_jax_cv2_branch_on_random_sets(U):
    """Ids and barycentrics against the JAX function itself (its cv2 branch)."""
    rng = np.random.default_rng(U)
    tri = np.concatenate([_corners(k, U, 60, rng) for k in KINDS])
    tex, fvt = _as_chart(tri, U)
    got = tdata.uv_face_tables(tex, fvt, U)
    want = jdata.uv_face_tables(tex, fvt, U)
    same = got[0] == want[0]
    assert same.all(), f"{int((~same).sum())} texels differ"
    np.testing.assert_allclose(got[1][same], want[1][same], atol=BARY_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("rig", [dict(body_side=24, head_side=10, uv_size=64),
                                 dict(body_side=64, head_side=12, uv_size=512)],
                         ids=["uv64", "uv512"])
def test_synthetic_rig_tables_equal_jax(rig, monkeypatch):
    monkeypatch.setenv("GUAVA_NO_RIG_CACHE", "1")
    _, _, jex = jsyn.synthetic_ehm(**rig, cache=False)
    _, _, tex = tsyn.synthetic_ehm(**rig)
    same = tex.uvmap_f_idx == jex.uvmap_f_idx
    assert same.all(), f"{int((~same).sum())} texels differ"
    np.testing.assert_allclose(tex.uvmap_f_bary[same], jex.uvmap_f_bary[same],
                               atol=BARY_ATOL, rtol=0)
    np.testing.assert_array_equal(tex.uvmap_mask, jex.uvmap_mask)


@pytest.mark.parametrize("W", [8, 16, 33])
def test_line_pixels_equal_cv2_line(W):
    rng = np.random.default_rng(W)
    p = rng.integers(-W, 2 * W, (400, 4))
    for x1, y1, x2, y2 in p:
        want = np.zeros((W, W), np.uint8)
        cv2.line(want, (int(x1), int(y1)), (int(x2), int(y2)), 1)
        got = np.zeros((W, W), np.uint8)
        _, y, x = tdata._line_pixels(W, W, *(np.array([v]) for v in (x1, y1, x2, y2)))
        got[y, x] = 1
        assert np.array_equal(got, want), (x1, y1, x2, y2)


def test_clip_lines_equals_cv2_clipline():
    rng = np.random.default_rng(1)
    p = rng.integers(-40, 56, (2000, 4))
    ok, x1, y1, x2, y2 = tdata._clip_lines(16, 16, *p.T)
    for i, (a, b, c, d) in enumerate(p):
        hit, q1, q2 = cv2.clipLine((0, 0, 16, 16), (int(a), int(b)), (int(c), int(d)))
        assert bool(ok[i]) == hit
        if hit:
            assert (q1, q2) == ((x1[i], y1[i]), (x2[i], y2[i])), (a, b, c, d)


def test_empty_chart():
    face_idx, bary, mask = tdata.uv_face_tables(np.zeros((0, 2), np.float32),
                                                np.zeros((0, 3), np.int32), 16)
    assert (face_idx == -1).all() and not mask.any() and not bary.any()


@pytest.mark.parametrize("rig,differ,texels", [
    (dict(body_side=24, head_side=10, uv_size=64), 483, 2844),
    (dict(body_side=64, head_side=12, uv_size=512), 10914, 174754)], ids=["uv64", "uv512"])
def test_replaced_fill_differed(rig, differ, texels, monkeypatch):
    """The fault this fill repairs: the half-plane rasterizer the port used
    before (the JAX package's numpy fallback, which it copied) binds other
    faces than the cv2 fill on this many texels of the synthetic charts."""
    monkeypatch.setenv("GUAVA_NO_RIG_CACHE", "1")
    _, _, jex = jsyn.synthetic_ehm(**rig, cache=False)
    old, _, _ = jdata._uv_face_tables_numpy(jex.texcoords, jex.faces_uv_idx, rig["uv_size"])
    assert int(jex.uvmap_mask.sum()) == texels
    assert int((old != jex.uvmap_f_idx).sum()) == differ
