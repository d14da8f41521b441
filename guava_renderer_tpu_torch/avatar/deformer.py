"""Per-frame avatar deformation (counterpart of
`guava_renderer_tpu/avatar/deformer.py`).

Vertex Gaussians ride the EHM-deformed vertices with their rotations
composed with the per-vertex LBS transform. UV Gaussians are re-anchored to
their binding face's frame: position = R_face @ local_xyz * face_scale +
barycentric center, rotation = face_quat o rotation, scale *= face_scale.

The per-face quantities go into a 16-channel face table and each texel
reads one row of it. Two gather paths share the component math:
  * default: a row gather of the (B, F, 16) table by binding face;
  * planned: texels face-sorted by a FaceSortPlan and the compact face
    table gathered by kernel K2 into channel-major (16, N) rows (its
    gradient by kernel K4). Requires a face-sorted avatar
    (sort_avatar_by_plan) and B == 1.
"""

from __future__ import annotations

import torch

from ..bodymodel.ehm import BodyParams, EhmModel, FlameParams, ehm_forward
from ..core.rotations import (
    matrix_to_quat,
    matrix_to_quat_comps,
    quat_multiply,
    quat_multiply_comps,
    quat_normalize,
)
from ..kernels.facegather import face_gather
from ..ops.facegather import FaceSortPlan
from ..utils.logging_utils import spanned
from .state import GaussianAvatar, GaussianSet


@spanned("guava.deform")
def deform_avatar(
    avatar: GaussianAvatar,
    ehm: EhmModel,
    faces: torch.Tensor,
    body: BodyParams,
    flame: FlameParams | None,
    plan: FaceSortPlan | None = None,
    compact_faces: torch.Tensor | None = None,
) -> GaussianSet:
    res = ehm_forward(ehm, body, flame)
    return deform_with_vertices(
        avatar, res.vertices, res.vertex_transforms, faces,
        plan=plan, compact_faces=compact_faces,
    )


def sort_avatar_by_plan(avatar: GaussianAvatar, plan: FaceSortPlan) -> GaussianAvatar:
    """Reorder the UV set into the plan's face-sorted texel order (once per avatar)."""
    perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=avatar.uv_local_xyz.device)
    return avatar._replace(
        uv_local_xyz=avatar.uv_local_xyz[:, perm],
        uv_colors=avatar.uv_colors[:, perm],
        uv_opacity=avatar.uv_opacity[:, perm],
        uv_scales=avatar.uv_scales[:, perm],
        uv_rotations=avatar.uv_rotations[:, perm],
        uv_binding_face=avatar.uv_binding_face[perm],
        uv_face_bary=avatar.uv_face_bary[perm],
        uv_valid=avatar.uv_valid[perm],
    )


def _safe_norm(x, y, z, eps=1e-12):
    """max(|v|, eps) with the clamp under the square root, so a zero vector
    (a degenerate face) has a zero gradient, not inf * 0."""
    return torch.sqrt(torch.clamp(x * x + y * y + z * z, min=eps * eps))


def _safe_inv_norm(x, y, z, eps=1e-12):
    return 1.0 / _safe_norm(x, y, z, eps)


def _face_table(tri: torch.Tensor) -> torch.Tensor:
    """Triangle corners (..., 3 corners, 3) -> (..., 16) face table:
    [frame quat wxyz, face scale, corner a xyz, edge b-a xyz, edge c-a xyz, 0, 0].

    The frame R has columns [t, n, bt] (tangent, normal, bitangent), carried
    as a unit quat; the isotropic face scale is (|e1| + |dot(bt, e2)|) / 2.
    """
    ax, ay, az = tri[..., 0, 0], tri[..., 0, 1], tri[..., 0, 2]
    bx, by, bz = tri[..., 1, 0], tri[..., 1, 1], tri[..., 1, 2]
    cx, cy, cz = tri[..., 2, 0], tri[..., 2, 1], tri[..., 2, 2]

    # tangent t = normalize(b - a); e2 = c - a
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    inv = _safe_inv_norm(e1x, e1y, e1z)
    tx, ty, tz = e1x * inv, e1y * inv, e1z * inv
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    # normal n = normalize(t x e2)
    nx_, ny_, nz_ = ty * e2z - tz * e2y, tz * e2x - tx * e2z, tx * e2y - ty * e2x
    inv = _safe_inv_norm(nx_, ny_, nz_)
    nx_, ny_, nz_ = nx_ * inv, ny_ * inv, nz_ * inv
    # bitangent bt = -normalize(n x t)
    ux_, uy_, uz_ = ny_ * tz - nz_ * ty, nz_ * tx - nx_ * tz, nx_ * ty - ny_ * tx
    inv = _safe_inv_norm(ux_, uy_, uz_)
    ux_, uy_, uz_ = -ux_ * inv, -uy_ * inv, -uz_ * inv

    s0 = _safe_norm(e1x, e1y, e1z)
    s1 = torch.abs(ux_ * e2x + uy_ * e2y + uz_ * e2z)
    fs = (s0 + s1) * 0.5

    fw, fx_, fy_, fz_ = matrix_to_quat_comps(tx, nx_, ux_, ty, ny_, uy_, tz, nz_, uz_)
    zero = torch.zeros_like(fs)
    return torch.stack([fw, fx_, fy_, fz_, fs, ax, ay, az,
                        e1x, e1y, e1z, e2x, e2y, e2z, zero, zero], dim=-1)


def _uv_from_rows(avatar, qw, qx, qy, qz, s_nn, ax, ay, az,
                  e1x, e1y, e1z, e2x, e2y, e2z):
    """Per-texel component math shared by both gather paths; all row
    components and the results are (B, N)-broadcastable."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)
    r10, r11, r12 = 2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)
    r20, r21, r22 = 2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)

    # barycentric center: u0*a + u1*b + u2*c == (u0+u1+u2)*a + u1*e1 + u2*e2
    u0 = avatar.uv_face_bary[None, :, 0]
    u1 = avatar.uv_face_bary[None, :, 1]
    u2 = avatar.uv_face_bary[None, :, 2]
    us = u0 + u1 + u2
    ctr_x = us * ax + u1 * e1x + u2 * e2x
    ctr_y = us * ay + u1 * e1y + u2 * e2y
    ctr_z = us * az + u1 * e1z + u2 * e2z

    lx, ly, lz = avatar.uv_local_xyz.unbind(-1)
    px = (r00 * lx + r01 * ly + r02 * lz) * s_nn + ctr_x
    py = (r10 * lx + r11 * ly + r12 * lz) * s_nn + ctr_y
    pz = (r20 * lx + r21 * ly + r22 * lz) * s_nn + ctr_z
    uv_xyz = torch.stack([px, py, pz], dim=-1)

    uv_rot = torch.stack(
        quat_multiply_comps(qw, qx, qy, qz, *avatar.uv_rotations.unbind(-1)), dim=-1)
    uv_scale = avatar.uv_scales * s_nn[..., None]
    # invalid chart texels render as nothing
    uv_op = avatar.uv_opacity * avatar.uv_valid[None, :, None]
    return uv_xyz, uv_rot, uv_scale, uv_op


def deform_with_vertices(
    avatar: GaussianAvatar,
    vertices: torch.Tensor,           # (B, V, 3) deformed EHM vertices
    vertex_transforms: torch.Tensor,  # (B, V, 4, 4)
    faces: torch.Tensor,              # (F, 3)
    plan: FaceSortPlan | None = None,
    compact_faces: torch.Tensor | None = None,
) -> GaussianSet:
    """UV-chart deformation through a per-face table (see module docstring)."""
    B = vertices.shape[0]
    d_rot = matrix_to_quat(vertex_transforms[:, :, :3, :3])
    vtx_rot = quat_normalize(quat_multiply(d_rot, avatar.vtx_rotations))

    if plan is not None:
        if B != 1 or compact_faces is None:
            raise ValueError("the planned path needs B == 1 and compact_faces")
        tri = vertices[0, compact_faces.reshape(-1)].reshape(-1, 3, 3)
        ids = torch.as_tensor(plan.compact_ids, device=vertices.device)
        seg = torch.as_tensor(plan.segment_starts, device=vertices.device)
        rows16 = face_gather(_face_table(tri), ids, seg)   # (16, N) channel-major
        rowc = [rows16[c][None] for c in range(14)]        # (1, N) each
    else:
        F = faces.shape[0]
        tri = vertices[:, faces.reshape(-1)].reshape(B, F, 3, 3)
        rows = _face_table(tri)[:, avatar.uv_binding_face]  # (B, N, 16)
        rowc = list(rows[..., :14].unbind(-1))

    uv_xyz, uv_rot, uv_scale, uv_op = _uv_from_rows(avatar, *rowc)
    return GaussianSet(
        xyz=torch.cat([vertices, uv_xyz], dim=1),
        rotation=torch.cat([vtx_rot, uv_rot], dim=1),
        scaling=torch.cat([avatar.vtx_scales, uv_scale], dim=1),
        opacity=torch.cat([avatar.vtx_opacity, uv_op], dim=1),
        colors=torch.cat([avatar.vtx_colors, avatar.uv_colors], dim=1),
    )


def canonical_gaussians(avatar: GaussianAvatar, faces: torch.Tensor) -> GaussianSet:
    """Canonical-space Gaussians: the avatar on its own vertices with identity
    transforms, through the row gather (ref: ubody_gaussian.py:291-313)."""
    B, V = avatar.vtx_positions.shape[:2]
    eye = torch.eye(4, dtype=avatar.vtx_positions.dtype, device=avatar.vtx_positions.device)
    return deform_with_vertices(avatar, avatar.vtx_positions, eye.expand(B, V, 4, 4), faces)
