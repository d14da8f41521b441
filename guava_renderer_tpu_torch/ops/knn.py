"""k-nearest-neighbour mean squared distance (counterpart of
`guava_renderer_tpu/ops/knn.py`, the reference's simple-knn `distCUDA2`).

The mean squared distance of each point to its k nearest others, the
standard 3DGS scale initializer; GUAVA itself never calls it. Exact by one
(P, P) distance matrix for P <= 2048; above that, each point looks at a
window of +-W neighbours in Morton order (one (P, 2W) distance matrix). The
sort is stable, as `jnp.argsort` is, so points with equal Morton codes get
the same windows as in the JAX package.
"""

from __future__ import annotations

import torch

EXACT_MAX = 2048


def _pairwise_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (M, 3) -> (N, M) squared distances."""
    an = (a * a).sum(-1, keepdim=True)
    bn = (b * b).sum(-1, keepdim=True).T
    return torch.clamp(an + bn - 2.0 * (a @ b.T), min=0.0)


def knn_mean_sq_dist_exact(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Exact: (P, 3) -> (P,) mean squared distance to the k nearest others."""
    d2 = _pairwise_sq(points, points)
    d2.fill_diagonal_(float("inf"))                  # exclude self
    return torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)


def _morton3(q: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit quantized xyz (P, 3) int64 -> (P,) Morton codes."""

    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3, window: int = 16) -> torch.Tensor:
    """Approximate (P, 3) -> (P,): Morton-window kNN (exact for P <= 2048)."""
    P = points.shape[0]
    if P <= EXACT_MAX:
        return knn_mean_sq_dist_exact(points, k)
    lo = points.min(0).values
    hi = points.max(0).values
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0).to(torch.int64)
    order = torch.argsort(_morton3(q), stable=True)
    sorted_pts = points[order]

    # each point against a +-window neighbourhood in Morton order
    dev = points.device
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    rows = torch.arange(P, device=dev)[:, None]
    idx = torch.clamp(rows + offs[None, :], 0, P - 1)                   # (P, 2W)
    d2 = ((sorted_pts[:, None, :] - sorted_pts[idx]) ** 2).sum(-1)
    # clipped indices at the ends land on the point itself: masked out
    d2 = torch.where(idx == rows, float("inf"), d2)
    mean_sorted = torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)
    out = torch.empty_like(mean_sorted)
    out[order] = mean_sorted
    return out
