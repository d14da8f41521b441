"""The port's kNN mean squared distance (`ops/knn.py`) against the JAX
package's `guava_renderer_tpu/ops/knn.py`: the exact route (P <= 2048) and
the Morton-window route, including a cloud whose Morton codes tie (64
cells, ~64 points a cell, each cell's points within one quantization step),
where the windows depend on the sort keeping ties in index order.

The exact route forms |a|^2 + |b|^2 - 2 a.b, whose cancellation for near
points leaves the two packages' matrix products apart by their rounding: it
is held to EXACT_RTOL plus ULPS float32 ulps of the largest |a|^2. The
window route takes differences directly and is held to WINDOW_RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import knn as jknn
from guava_renderer_tpu_torch.ops import knn

EXACT_RTOL = 1e-5
ULPS = 4
WINDOW_RTOL = 1e-6


def _exact_atol(pts):
    return ULPS * np.finfo(np.float32).eps * float((pts.astype(np.float64) ** 2).sum(-1).max())


def _cloud(kind: str, P: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(P, 3)).astype(np.float32)
    if kind == "surface":       # points on a sphere shell, as splat centres lie
        v = rng.normal(size=(P, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)
                * rng.uniform(0.98, 1.02, (P, 1))).astype(np.float32)
    # "tied": 4 x 4 x 4 cells over [0, 1023], points within 0.4 of a step of
    # their cell's corner, so cell-mates share a Morton code
    cells = rng.integers(0, 4, (P, 3)) * 341.0
    pts = cells + rng.uniform(0.0, 0.4, (P, 3))
    pts[0], pts[1] = 0.0, 1023.0       # the range is [0, 1023]: one step a unit
    return pts.astype(np.float32)


CASES = [("normal", 300, "exact"), ("surface", 2048, "exact"), ("normal", 5000, "window"),
         ("surface", 4099, "window"), ("tied", 4096, "window")]


def _jax(fn, pts, **kw):
    return np.asarray(jax.jit(lambda p: fn(p, **kw))(jnp.asarray(pts)))


@pytest.mark.parametrize("kind,P,route", CASES, ids=[f"{k}-{p}" for k, p, _ in CASES])
def test_knn_vs_jax(kind, P, route):
    pts = _cloud(kind, P)
    got = knn.knn_mean_sq_dist(torch.tensor(pts)).numpy()
    want = _jax(jknn.knn_mean_sq_dist, pts)
    assert got.shape == want.shape == (P,)
    assert np.isfinite(got).all() and (got >= 0).all()
    if route == "exact":
        np.testing.assert_allclose(got, want, rtol=EXACT_RTOL, atol=_exact_atol(pts))
    else:
        np.testing.assert_allclose(got, want, rtol=WINDOW_RTOL, atol=WINDOW_RTOL * want.max())


@pytest.mark.parametrize("k", [1, 3, 8])
def test_exact_vs_jax(k):
    pts = _cloud("normal", 500, seed=k)
    got = knn.knn_mean_sq_dist_exact(torch.tensor(pts), k=k).numpy()
    want = _jax(jknn.knn_mean_sq_dist_exact, pts, k=k)
    np.testing.assert_allclose(got, want, rtol=EXACT_RTOL, atol=_exact_atol(pts))


@pytest.mark.parametrize("window", [4, 16])
def test_window_sizes_vs_jax(window):
    pts = _cloud("tied", 3000, seed=window)
    got = knn.knn_mean_sq_dist(torch.tensor(pts), window=window).numpy()
    want = _jax(jknn.knn_mean_sq_dist, pts, window=window)
    np.testing.assert_allclose(got, want, rtol=WINDOW_RTOL, atol=WINDOW_RTOL * want.max())


def test_morton_codes_and_their_stable_order_vs_jax():
    pts = _cloud("tied", 4096)
    lo, hi = pts.min(0), pts.max(0)
    q = ((pts - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint32)
    want = np.asarray(jknn._morton3(jnp.asarray(q)).astype(jnp.int32))
    got = knn._morton3(torch.tensor(q.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) < len(want) // 8          # the codes do tie
    np.testing.assert_array_equal(torch.argsort(torch.tensor(got), stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))


def test_exact_excludes_the_point_itself():
    pts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3], [5, 5, 5]], np.float32)
    got = knn.knn_mean_sq_dist_exact(torch.tensor(pts), k=1).numpy()
    np.testing.assert_allclose(got, [1.0, 1.0, 4.0, 9.0, 54.0], rtol=1e-6)
