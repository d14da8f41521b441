"""Pinhole camera with the Gaussian-splatting projection conventions
(counterpart of `guava_renderer_tpu/core/cameras.py`).

COLMAP-style world-to-camera, GL-style perspective with z_near=0.01 /
z_far=100, and the rasterizer's ndc->pixel mapping `((ndc + 1) * S - 1) / 2`.
Matrices are kept in math convention (apply as M @ p).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.logging_utils import span


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor        # (3, 3) world-to-camera rotation
    t: torch.Tensor        # (3,) world-to-camera translation
    tanfovx: torch.Tensor  # 0-d f32
    tanfovy: torch.Tensor  # 0-d f32
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @staticmethod
    def from_w2c(w2c: torch.Tensor, tanfov: float, width: int, height: int) -> "Camera":
        """Camera from a (4, 4) world-to-camera matrix and a square fov."""
        with span("guava.sync.camera"):     # an upload from pageable host memory
            tf = torch.tensor(tanfov, dtype=torch.float32, device=w2c.device)
        return Camera(R=w2c[:3, :3], t=w2c[:3, 3], tanfovx=tf, tanfovy=tf,
                      width=width, height=height)

    @staticmethod
    def from_gs_layout(world_view_transform: torch.Tensor, tanfovx, tanfovy,
                       width: int, height: int) -> "Camera":
        """Camera from the reference data layer's transposed view matrix."""
        V = world_view_transform.T
        dev = world_view_transform.device
        return Camera(R=V[:3, :3], t=V[:3, 3],
                      tanfovx=torch.as_tensor(tanfovx, dtype=torch.float32, device=dev),
                      tanfovy=torch.as_tensor(tanfovy, dtype=torch.float32, device=dev),
                      width=width, height=height)

    @property
    def campos(self) -> torch.Tensor:
        """Camera center in world space: -R^T t."""
        return -self.R.T @ self.t

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tanfovy)

    def view_matrix(self) -> torch.Tensor:
        V = torch.zeros((4, 4), dtype=torch.float32, device=self.R.device)
        V[:3, :3] = self.R
        V[:3, 3] = self.t
        with span("guava.sync.camera"):     # a host scalar stored into the device's matrix
            V[3, 3] = 1.0
        return V

    def proj_matrix(self) -> torch.Tensor:
        zn, zf = self.znear, self.zfar
        P = torch.zeros((4, 4), dtype=torch.float32, device=self.R.device)
        P[0, 0] = 1.0 / self.tanfovx
        P[1, 1] = 1.0 / self.tanfovy
        with span("guava.sync.camera"):     # host scalars stored into the device's matrix
            P[2, 2] = zf / (zf - zn)
            P[2, 3] = -(zf * zn) / (zf - zn)
            P[3, 2] = 1.0
        return P

    def full_proj_matrix(self) -> torch.Tensor:
        return self.proj_matrix() @ self.view_matrix()

    def gs_layout(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(view^T, (proj@view)^T), the reference data layer's row-vector layout."""
        return self.view_matrix().T, self.full_proj_matrix().T


def world_to_cam(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3) world -> camera space."""
    return pts @ cam.R.T + cam.t


def project_points(cam: Camera, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> (pixel xy (..., 2), camera-space depth (...,)), by the
    rasterizer's ndc->pixel convention."""
    z = world_to_cam(cam, pts)[..., 2]
    full = cam.full_proj_matrix()
    hom = pts @ full[:3, :3].T + full[:3, 3]
    w = pts @ full[3, :3] + full[3, 3]
    ndc = hom[..., :2] / (w[..., None] + 1e-7)
    px = ndc2pix(ndc[..., 0], cam.width)
    py = ndc2pix(ndc[..., 1], cam.height)
    return torch.stack([px, py], dim=-1), z


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def look_at_camera(eye, target, up=(0.0, 1.0, 0.0), tanfov: float = 0.34,
                   width: int = 512, height: int = 512, device="cuda") -> Camera:
    """World-to-camera looking from eye to target (z forward), on `device`."""
    from ..device import resolve_device

    dev = resolve_device(device)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    eye, target, up = f32(eye), f32(target), f32(up)
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd])  # rows: the camera axes in world space
    return Camera(R=R, t=-R @ eye, tanfovx=f32(tanfov), tanfovy=f32(tanfov),
                  width=width, height=height)
