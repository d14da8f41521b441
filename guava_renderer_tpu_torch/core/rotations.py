"""Batched rotation algebra on tensors (counterpart of
`guava_renderer_tpu/core/rotations.py`).

Quaternions are wxyz (scalar first), the Gaussian rasterizer's convention.
All functions accept arbitrary leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. aa: (..., 3) -> (..., 3, 3)."""
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(angle, min=_EPS)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_multiply_comps(aw, ax, ay, az, bw, bx, by, bz):
    """Hamilton product on component tensors."""
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz. (..., 4) x (..., 4) -> (..., 4)."""
    return torch.stack(quat_multiply_comps(*a.unbind(-1), *b.unbind(-1)), dim=-1)


def matrix_to_quat_comps(m00, m01, m02, m10, m11, m12, m20, m21, m22):
    """Branchless Shepperd's method on component tensors -> (w, x, y, z).

    The candidate choice (and with it the sign before the final w >= 0 flip)
    follows the JAX reference select for select.
    """
    t0 = 1 + m00 + m11 + m22
    t1 = 1 + m00 - m11 - m22
    t2 = 1 - m00 + m11 - m22
    t3 = 1 - m00 - m11 + m22

    cands = (
        (t0, m21 - m12, m02 - m20, m10 - m01),
        (m21 - m12, t1, m01 + m10, m02 + m20),
        (m02 - m20, m01 + m10, t2, m12 + m21),
        (m10 - m01, m02 + m20, m12 + m21, t3),
    )
    best01 = t0 >= t1
    best23 = t2 >= t3
    tmax01 = torch.where(best01, t0, t1)
    tmax23 = torch.where(best23, t2, t3)
    front = tmax01 >= tmax23

    def sel(k):
        a = torch.where(best01, cands[0][k], cands[1][k])
        b = torch.where(best23, cands[2][k], cands[3][k])
        return torch.where(front, a, b)

    w, x, y, z = sel(0), sel(1), sel(2), sel(3)
    inv = 1.0 / torch.clamp(torch.sqrt(w * w + x * x + y * y + z * z), min=_EPS)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    neg = w < 0
    return (
        torch.where(neg, -w, w),
        torch.where(neg, -x, x),
        torch.where(neg, -y, y),
        torch.where(neg, -z, z),
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """R: (..., 3, 3) -> (..., 4) wxyz."""
    comps = matrix_to_quat_comps(*R.reshape(R.shape[:-2] + (9,)).unbind(-1))
    return torch.stack(comps, dim=-1)
