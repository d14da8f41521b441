"""Linear blend skinning (counterpart of `guava_renderer_tpu/core/lbs.py`).

The kinematic chain is composed level by level (joints grouped by tree
depth), as in the reference; all functions take a leading batch dim B.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.logging_utils import span
from .rotations import axis_angle_to_matrix


class LbsResult(NamedTuple):
    vertices: torch.Tensor           # (B, V, 3) posed vertices
    joints_rest: torch.Tensor        # (B, J, 3)
    joints_posed: torch.Tensor       # (B, J, 3)
    joint_transforms: torch.Tensor   # (B, J, 4, 4)
    vertex_transforms: torch.Tensor  # (B, V, 4, 4)


def blend_shapes(coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """coeffs (B, L) x dirs (V, 3, L) -> per-vertex offsets (B, V, 3)."""
    return torch.einsum("bl,vcl->bvc", coeffs, dirs)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """J_regressor (J, V) x vertices (B, V, 3) -> joints (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", J_regressor, vertices)


def kinematic_levels(parents: Sequence[int]) -> list[np.ndarray]:
    """Joint indices grouped by depth in the kinematic tree (root excluded)."""
    parents = np.asarray(parents)
    depth = np.zeros(len(parents), dtype=np.int64)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    return [np.nonzero(depth == d)[0] for d in range(1, int(depth.max()) + 1)]


def rigid_transform_chain(
    rot_mats: torch.Tensor,
    joints_rest: torch.Tensor,
    parents: Sequence[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, J, 3, 3) local rotations + (B, J, 3) rest joints ->
    (joints_posed (B, J, 3), rel_transforms (B, J, 4, 4))."""
    parents_np = np.asarray(parents)
    B, J = rot_mats.shape[:2]
    dev = rot_mats.device

    # the tree's indices are uploaded from pageable host memory
    with span("guava.sync.lbs"):
        parents_t = torch.as_tensor(np.maximum(parents_np, 0), device=dev)
    parent_pos = joints_rest[:, parents_t].clone()
    parent_pos[:, 0] = 0.0
    rel_j = joints_rest - parent_pos

    local = torch.zeros((B, J, 4, 4), dtype=rot_mats.dtype, device=dev)
    local[:, :, :3, :3] = rot_mats
    local[:, :, :3, 3] = rel_j
    local[:, :, 3, 3] = 1.0

    world = local.clone()
    for idx in kinematic_levels(parents_np):
        with span("guava.sync.lbs"):
            par = torch.as_tensor(parents_np[idx], device=dev)
            idx_t = torch.as_tensor(idx, device=dev)
        world[:, idx_t] = world[:, par] @ local[:, idx_t]

    joints_posed = world[:, :, :3, 3]
    t_correct = torch.einsum("bjrc,bjc->bjr", world[:, :, :3, :3], joints_rest)
    rel = world.clone()
    rel[:, :, :3, 3] -= t_correct
    return joints_posed, rel


def skinning_transforms(rel_transforms: torch.Tensor, lbs_weights: torch.Tensor) -> torch.Tensor:
    """(B, J, 4, 4) x lbs_weights (V, J) -> (B, V, 4, 4)."""
    B, J = rel_transforms.shape[:2]
    T = torch.einsum("vj,bjk->bvk", lbs_weights, rel_transforms.reshape(B, J, 16))
    return T.reshape(B, -1, 4, 4)


def apply_vertex_transforms(vertices: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply (B, V, 4, 4) to (B, V, 3)."""
    return torch.einsum("bvrc,bvc->bvr", T[:, :, :3, :3], vertices) + T[:, :, :3, 3]


def pose_feature(rot_mats: torch.Tensor) -> torch.Tensor:
    """(R_j - I) for joints 1.., flattened: (B, J, 3, 3) -> (B, (J-1)*9)."""
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    return (rot_mats[:, 1:] - eye).reshape(rot_mats.shape[0], -1)


def lbs(
    pose: torch.Tensor,
    v_template: torch.Tensor,
    joints_rest: torch.Tensor | None,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
    *,
    betas: torch.Tensor | None = None,
    shapedirs: torch.Tensor | None = None,
    posedirs: torch.Tensor | None = None,
    J_regressor: torch.Tensor | None = None,
    pose2rot: bool = True,
) -> LbsResult:
    """Full LBS forward; see the JAX `core.lbs.lbs` for the argument contract."""
    rot_mats = axis_angle_to_matrix(pose) if pose2rot else pose
    B = rot_mats.shape[0]

    v_shaped = v_template.expand((B,) + v_template.shape) if v_template.ndim == 2 else v_template
    if betas is not None and shapedirs is not None:
        v_shaped = v_shaped + blend_shapes(betas, shapedirs)

    if joints_rest is None:
        if J_regressor is None:
            raise ValueError("need J_regressor when joints_rest is None")
        joints_rest = vertices2joints(J_regressor, v_shaped)

    if posedirs is not None:
        v_shaped = v_shaped + torch.einsum("bl,vcl->bvc", pose_feature(rot_mats), posedirs)

    joints_posed, rel = rigid_transform_chain(rot_mats, joints_rest, parents)
    T = skinning_transforms(rel, lbs_weights)
    verts = apply_vertex_transforms(v_shaped, T)
    return LbsResult(verts, joints_rest, joints_posed, rel, T)


def vertices2landmarks(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    lmk_faces_idx: torch.Tensor,
    lmk_bary_coords: torch.Tensor,
) -> torch.Tensor:
    """Barycentric landmarks: vertices (B, V, 3), faces (F, 3), lmk_faces_idx
    (B, L) or (L,), lmk_bary_coords (B, L, 3) or (L, 3) -> (B, L, 3)."""
    B = vertices.shape[0]
    if lmk_faces_idx.ndim == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(B, -1)
    if lmk_bary_coords.ndim == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand(B, -1, -1)
    tri = faces.long()[lmk_faces_idx.long()]                       # (B, L, 3)
    tri_verts = vertices[torch.arange(B, device=vertices.device)[:, None, None], tri]
    return torch.einsum("blvc,blv->blc", tri_verts, lmk_bary_coords)
