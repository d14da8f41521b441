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


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """aa: (..., 3) -> unit quaternion (..., 4) wxyz."""
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sinc form, stable as angle -> 0
    k = torch.where(angle < 1e-6, 0.5 - angle**2 / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=_EPS))
    return torch.cat([torch.cos(half), aa * k], dim=-1)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(matrix_to_quat(R))


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """q: (..., 4) wxyz -> (..., 3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0: the shortest arc
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)[..., None]
    scale = torch.where(norm < 1e-8, torch.full_like(norm, 2.0),
                        angle / torch.clamp(norm, min=_EPS))
    return xyz * scale


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """q: (..., 4) wxyz (normalized inside) -> (..., 3, 3)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    r1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    r2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """x: (..., 6) -> (..., 3, 3) by Gram-Schmidt on two column vectors."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=_EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1, keepdim=True), min=_EPS)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def euler_to_matrix(e: torch.Tensor) -> torch.Tensor:
    """e: (..., 3) radians, applied as Rz @ Ry @ Rx."""
    x, y, z = e.unbind(-1)
    cx, sx, cy, sy, cz, sz = x.cos(), x.sin(), y.cos(), y.sin(), z.cos(), z.sin()
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    Rx = _stack33(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    Ry = _stack33(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    Rz = _stack33(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    return Rz @ Ry @ Rx


def _stack33(*vals):
    return torch.stack([torch.stack(vals[i * 3:i * 3 + 3], dim=-1) for i in range(3)], dim=-2)


def rt_to_mat4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    M = R.new_zeros(R.shape[:-2] + (4, 4))
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


def transform_points(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    return pts @ M[..., :3, :3].transpose(-1, -2) + M[..., None, :3, 3]
