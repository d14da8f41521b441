"""Mesh preview renders on the z-buffer rasterizer (counterpart of
`guava_renderer_tpu/ops/mesh_preview.py`): position / LBS-weight attribute
renders and UV-textured previews, for debugging and for viewing the
predicted uvmap_texture. Both reach kernel K5 through `rasterize_mesh`.
"""

from __future__ import annotations

import torch

from ..avatar.sampling import grid_sample
from ..core.cameras import Camera
from .meshraster import interpolate_attributes, rasterize_mesh


def render_mesh_attributes(verts: torch.Tensor, faces: torch.Tensor,
                           vertex_attrs: torch.Tensor,
                           cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (attr image (H, W, A), alpha (H, W, 1)); e.g. positions or LBS
    weights as attributes."""
    res = rasterize_mesh(verts, faces, cam)
    img = interpolate_attributes(res, faces, vertex_attrs)
    return img, (res.face_idx >= 0).float()[..., None]


def render_textured_mesh(verts: torch.Tensor, faces: torch.Tensor,
                         faces_uv_idx: torch.Tensor, texcoords: torch.Tensor,
                         texture: torch.Tensor, cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """UV-textured preview. texture (U, U, C) in image-space v; texcoords
    (T, 2) image-space -> (rgb (H, W, C), alpha (H, W, 1))."""
    res = rasterize_mesh(verts, faces, cam)
    hit = res.face_idx >= 0
    tri_uv = texcoords[faces_uv_idx.long()[torch.clamp(res.face_idx, min=0).long()]]  # (H, W, 3, 2)
    uv = torch.einsum("hwkc,hwk->hwc", tri_uv, res.bary)
    rgb = grid_sample(texture[None], (uv * 2.0 - 1.0)[None], padding="border")[0]
    return torch.where(hit[..., None], rgb, 0.0), hit.float()[..., None]
