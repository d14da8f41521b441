"""Gaussian projection, EWA splatting and culling (counterpart of
`guava_renderer_tpu/ops/gsplat_project.py`).

Frustum cull at view z <= 0.2, quaternion (wxyz, not renormalized) ->
covariance factor M = R diag(s), EWA Jacobian with +/-1.3*tanfov clamping,
+0.3 pixel covariance dilation, 3-sigma ceil radius, `((ndc+1)*S-1)/2`
pixel mapping. `radius_bin` is the per-axis, opacity-tightened extent
(floored at 0.3 sigma, +1 pixel of slack, capped at the 3-sigma radius)
that binning uses.

Differentiable in means, scales, quats and opacities through `mean2d`,
`conic`, `alpha` and `depth`. The divisions by view z take 1 in place of
the z of a Gaussian at or behind the near plane, so a culled Gaussian has
finite values and a zero (not NaN) gradient; the radii are integers and
carry none.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.cameras import Camera, ndc2pix

NEAR_CULL_Z = 0.2
COV_DILATION = 0.3


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor      # (P, 2) pixel coords
    conic: torch.Tensor       # (P, 3) inverse 2D covariance (a, b, c)
    alpha: torch.Tensor       # (P,) opacity (x antialiasing scale if enabled)
    depth: torch.Tensor       # (P,) camera-space z
    radius: torch.Tensor      # (P,) int32 3-sigma pixel radius (0 = culled)
    radius_bin: torch.Tensor  # (P, 2) int32 per-axis binning extent
    valid: torch.Tensor       # (P,) bool


def quat_scale_to_cov3d_rows(quats: torch.Tensor, scales: torch.Tensor):
    """(P, 4) wxyz and (P, 3) -> the 9 entries of M = R diag(s) as (P,) tensors."""
    r, x, y, z = quats.unbind(-1)
    sx, sy, sz = scales.unbind(-1)
    return (
        (1 - 2 * (y * y + z * z)) * sx,
        (2 * (x * y - r * z)) * sy,
        (2 * (x * z + r * y)) * sz,
        (2 * (x * y + r * z)) * sx,
        (1 - 2 * (x * x + z * z)) * sy,
        (2 * (y * z - r * x)) * sz,
        (2 * (x * z - r * y)) * sx,
        (2 * (y * z + r * x)) * sy,
        (1 - 2 * (x * x + y * y)) * sz,
    )


def mark_visible(means3d: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Frustum pre-cull, (P, 3) -> (P,) bool: camera-space z > 0.2 (the
    reference's `markVisible`, whose NDC bounds check is commented out)."""
    return (means3d @ cam.R.T + cam.t)[:, 2] > NEAR_CULL_Z


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
) -> ProjectedGaussians:
    P = means3d.shape[0]
    opacities = opacities.reshape(P)

    p_view = means3d @ cam.R.T + cam.t
    tz = p_view[:, 2]
    in_front = tz > NEAR_CULL_Z

    full = cam.full_proj_matrix()
    hom = means3d @ full[:3, :3].T + full[:3, 3]
    w = means3d @ full[3, :3] + full[3, 3]
    inv_w = 1.0 / (torch.where(in_front, w, 1.0) + 1e-7)
    mean2d = torch.stack(
        [ndc2pix(hom[:, 0] * inv_w, cam.width), ndc2pix(hom[:, 1] * inv_w, cam.height)],
        dim=-1,
    )

    m00, m01, m02, m10, m11, m12, m20, m21, m22 = quat_scale_to_cov3d_rows(
        quats, scales * scale_modifier)

    # EWA: clamp the tangent before building the Jacobian
    lim_x = 1.3 * cam.tanfovx
    lim_y = 1.3 * cam.tanfovy
    tz_safe = torch.where(in_front, tz, 1.0)
    txz = torch.clamp(p_view[:, 0] / tz_safe, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(p_view[:, 1] / tz_safe, -lim_y, lim_y) * tz_safe
    fx, fy = cam.focal_x, cam.focal_y
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * txz * inv_z2
    j11, j12 = fy * inv_z, -fy * tyz * inv_z2
    R = cam.R
    u0 = j00 * R[0, 0] + j02 * R[2, 0]
    u1 = j00 * R[0, 1] + j02 * R[2, 1]
    u2 = j00 * R[0, 2] + j02 * R[2, 2]
    v0 = j11 * R[1, 0] + j12 * R[2, 0]
    v1 = j11 * R[1, 1] + j12 * R[2, 1]
    v2 = j11 * R[1, 2] + j12 * R[2, 2]
    # cov2d = (JW M)(JW M)^T with p, q the two rows of JW M
    p0 = u0 * m00 + u1 * m10 + u2 * m20
    p1 = u0 * m01 + u1 * m11 + u2 * m21
    p2 = u0 * m02 + u1 * m12 + u2 * m22
    q0 = v0 * m00 + v1 * m10 + v2 * m20
    q1 = v0 * m01 + v1 * m11 + v2 * m21
    q2 = v0 * m02 + v1 * m12 + v2 * m22
    a = p0 * p0 + p1 * p1 + p2 * p2
    b = p0 * q0 + p1 * q1 + p2 * q2
    c = q0 * q0 + q1 * q1 + q2 * q2
    det_raw = a * c - b * b
    a = a + COV_DILATION
    c = c + COV_DILATION
    det = a * c - b * b

    alpha = opacities
    if antialiasing:
        alpha = opacities * torch.sqrt(torch.clamp(det_raw / det, min=2.5e-5))

    nonzero = det != 0.0
    det_inv = 1.0 / torch.where(nonzero, det, 1.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    # 3-sigma radius from the max eigenvalue; binning extents tightened by
    # opacity (alpha >= 1/255 only inside q <= 2 ln(255 a0)) and per axis.
    # Integers: computed outside the graph.
    with torch.no_grad():
        a_, c_, det_, alpha_ = a.detach(), c.detach(), det.detach(), alpha.detach()
        mid = 0.5 * (a_ + c_)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det_, min=0.1))
        sig = torch.sqrt(torch.clamp(lam, min=0.0))
        nsig = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * alpha_, min=1.0))),
                           min=0.3)
        radius_f = torch.ceil(3.0 * sig)
        rx_f = torch.minimum(torch.ceil(nsig * torch.sqrt(torch.clamp(a_, min=0.0))) + 1.0,
                             radius_f)
        ry_f = torch.minimum(torch.ceil(nsig * torch.sqrt(torch.clamp(c_, min=0.0))) + 1.0,
                             radius_f)
        valid = in_front & nonzero & (radius_f > 0)
        radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
        radius_bin = torch.where(valid[:, None], torch.stack([rx_f, ry_f], dim=-1),
                                 0.0).to(torch.int32)
    return ProjectedGaussians(mean2d, conic, alpha, tz, radius, radius_bin, valid)


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor, width: int, height: int,
              tile: int = 16):
    """Tile-grid bounding rect per Gaussian: (x0, y0, x1, y1) int32,
    max-exclusive, clamped to the grid. `radius` is (P,) or per-axis (P, 2).
    The float -> int32 conversion truncates toward zero, as in the reference."""
    gx = math.ceil(width / tile)
    gy = math.ceil(height / tile)
    r = radius.float()
    rx, ry = (r[:, 0], r[:, 1]) if r.dim() == 2 else (r, r)
    x0 = torch.clamp(((mean2d[:, 0] - rx) / tile).to(torch.int32), 0, gx)
    y0 = torch.clamp(((mean2d[:, 1] - ry) / tile).to(torch.int32), 0, gy)
    x1 = torch.clamp(((mean2d[:, 0] + rx + tile - 1) / tile).to(torch.int32), 0, gx)
    y1 = torch.clamp(((mean2d[:, 1] + ry + tile - 1) / tile).to(torch.int32), 0, gy)
    return x0, y0, x1, y1
