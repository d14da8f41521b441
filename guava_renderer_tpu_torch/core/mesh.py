"""Mesh geometry helpers (counterpart of `guava_renderer_tpu/core/mesh.py`).

`face_orientation` is the per-face TBN frame and scale that binds UV
Gaussians to the deforming surface.
"""

from __future__ import annotations

import torch

_EPS = 1e-20


def _safe_normalize(x: torch.Tensor) -> torch.Tensor:
    n2 = (x * x).sum(-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(n2, min=_EPS))


def face_orientation(verts: torch.Tensor, faces: torch.Tensor, return_scale: bool = True):
    """Per-face orthonormal frame and isotropic scale.

    verts (..., V, 3), faces (F, 3) -> R (..., F, 3, 3) with columns
    [tangent, normal, -bitangent] and scale (..., F, 1)."""
    faces = faces.long()
    v0, v1, v2 = verts[..., faces[:, 0], :], verts[..., faces[:, 1], :], verts[..., faces[:, 2], :]
    a0 = _safe_normalize(v1 - v0)
    a1 = _safe_normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -_safe_normalize(torch.linalg.cross(a1, a0))
    R = torch.stack([a0, a1, a2], dim=-1)
    if not return_scale:
        return R, None
    s0 = torch.linalg.vector_norm(v1 - v0, dim=-1, keepdim=True)
    s1 = (a2 * (v2 - v0)).sum(-1, keepdim=True).abs()
    return R, (s0 + s1) / 2.0


def face_centers_bary(verts: torch.Tensor, faces: torch.Tensor, face_idx: torch.Tensor,
                      bary: torch.Tensor) -> torch.Tensor:
    """Surface points of (face id, barycentric) bindings: verts (..., V, 3),
    faces (F, 3), face_idx (N,), bary (N, 3) -> (..., N, 3)."""
    pts = verts[..., faces.long()[face_idx.long()], :]          # (..., N, 3, 3)
    return torch.einsum("...nkc,nk->...nc", pts, bary)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals. verts (V, 3) or (B, V, 3)."""
    batched = verts.ndim == 3
    if not batched:
        verts = verts[None]
    faces = faces.long()
    v0, v1, v2 = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    out = torch.zeros_like(verts)
    for k in range(3):
        out = out.index_add(1, faces[:, k], fn)
    out = _safe_normalize(out)
    return out if batched else out[0]
