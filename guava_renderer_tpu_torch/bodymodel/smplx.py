"""Standalone SMPL-X and FLAME forwards, outside the EHM hybrid
(counterpart of `guava_renderer_tpu/bodymodel/smplx.py`).

SMPL-X: eyelid blendshapes and per-part head/hand scaling about the template
centroids applied to the template, then LBS with shape and expression
blendshapes; `pose_rel2abs` composes a kinematic chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lbs as lbs_core
from .data import SmplxExtras
from .ehm import BodyParams, FlameParams, _as_rotmats, _maybe_pose, _pad_shape


class SmplxResult(NamedTuple):
    vertices: torch.Tensor
    joints_rest: torch.Tensor
    joints_posed: torch.Tensor
    joint_transforms: torch.Tensor
    vertex_transforms: torch.Tensor


def smplx_forward(
    data_t: dict,
    parents,
    extras_t: dict,
    body: BodyParams,
    eyelid_params: torch.Tensor | None = None,
    n_shape: int = 300,
    n_exp: int = 50,
) -> SmplxResult:
    """data_t = ParametricModelData.torch(device); extras_t = extras_to_torch(...)."""
    B = body.shape.shape[0]
    dev = body.shape.device
    exp = body.exp if body.exp is not None else torch.zeros((B, n_exp), device=dev)
    shape_components = torch.cat([_pad_shape(body.shape, n_shape), exp], dim=-1)

    full_pose = torch.cat([
        _maybe_pose(body.global_pose, B, 1, dev),
        _as_rotmats(body.body_pose),
        torch.eye(3, device=dev).expand(B, 3, 3, 3),      # jaw + eyes
        _maybe_pose(body.left_hand_pose, B, 15, dev),
        _maybe_pose(body.right_hand_pose, B, 15, dev),
    ], dim=1)

    template = data_t["v_template"].expand((B,) + data_t["v_template"].shape).clone()
    head_ind = extras_t["smplx2flame_ind"]
    head_vert = template[:, head_ind]
    if eyelid_params is not None and "l_eyelid" in data_t:
        head_vert = head_vert + data_t["r_eyelid"][None, head_ind] * eyelid_params[:, 1, None, None]
        head_vert = head_vert + data_t["l_eyelid"][None, head_ind] * eyelid_params[:, 0, None, None]
    if body.head_scale is not None:
        hs = body.head_scale[:, None]
        head_vert = head_vert * hs + (1 - hs) * extras_t["head_center"][None, None]
    template[:, head_ind] = head_vert
    if body.hand_scale is not None:
        hs = body.hand_scale[:, None]
        for side in ("left", "right"):
            ind = extras_t[f"{side}_hand_ind"]
            ctr = extras_t[f"{side}_hand_center"]
            template[:, ind] = template[:, ind] * hs + (1 - hs) * ctr[None, None]

    template = template + lbs_core.blend_shapes(shape_components, data_t["shapedirs"])
    if body.static_offset is not None:
        template = template + body.static_offset
    joints = lbs_core.vertices2joints(data_t["J_regressor"], template)
    if body.joints_offset is not None:
        joints = joints + body.joints_offset

    res = lbs_core.lbs(full_pose, template, joints, parents, data_t["lbs_weights"],
                       posedirs=data_t["posedirs"], pose2rot=False)
    return SmplxResult(vertices=res.vertices, joints_rest=joints,
                       joints_posed=res.joints_posed,
                       joint_transforms=res.joint_transforms,
                       vertex_transforms=res.vertex_transforms)


# kinematic chains of the absolute pose queries, leaf first
_ABS_CHAINS = {
    "head": (15, 12, 9, 6, 3, 0),
    "neck": (12, 9, 6, 3, 0),
    "right_wrist": (21, 19, 17, 14, 9, 6, 3, 0),
    "left_wrist": (20, 18, 16, 13, 9, 6, 3, 0),
}


def pose_rel2abs(global_pose: torch.Tensor, body_pose: torch.Tensor,
                 abs_joint: str = "head") -> torch.Tensor:
    """Relative -> absolute rotation along the kinematic chain: (B, 1, 3, 3)."""
    full = torch.cat([_as_rotmats(global_pose), _as_rotmats(body_pose)], dim=1)
    B = full.shape[0]
    R = torch.eye(3, dtype=full.dtype, device=full.device).expand(B, 3, 3)
    for idx in _ABS_CHAINS[abs_joint]:
        R = full[:, idx] @ R
    return R[:, None]


def flame_forward(
    data_t: dict,
    parents,
    flame: FlameParams,
    neck_pose: torch.Tensor | None = None,
    global_pose: torch.Tensor | None = None,
    n_shape: int = 300,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Standalone FLAME LBS. Returns (vertices (B, V, 3), joints_posed (B, 5, 3))."""
    B = flame.shape.shape[0]
    dev = flame.shape.device
    betas = torch.cat([_pad_shape(flame.shape, n_shape), flame.exp], dim=-1)
    glob = global_pose if global_pose is not None else torch.zeros((B, 3), device=dev)
    neck = neck_pose if neck_pose is not None else torch.zeros((B, 3), device=dev)
    eyes = flame.eyes if flame.eyes is not None else torch.zeros((B, 6), device=dev)
    pose = torch.cat([glob.reshape(B, 3), neck.reshape(B, 3), flame.jaw.reshape(B, 3),
                      eyes.reshape(B, 6)], dim=-1).reshape(B, 5, 3)
    res = lbs_core.lbs(pose, data_t["v_template"], None, parents, data_t["lbs_weights"],
                       betas=betas, shapedirs=data_t["shapedirs"],
                       posedirs=data_t["posedirs"], J_regressor=data_t["J_regressor"])
    verts = res.vertices
    if flame.eyelids is not None and "l_eyelid" in data_t:
        verts = verts + data_t["r_eyelid"][None] * flame.eyelids[:, 1, None, None]
        verts = verts + data_t["l_eyelid"][None] * flame.eyelids[:, 0, None, None]
    return verts, res.joints_posed


def extras_to_torch(extras: SmplxExtras, device) -> dict[str, torch.Tensor]:
    """The index maps and centres `smplx_forward` reads, as tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(getattr(extras, k)), dtype=torch.int64, device=device)
           for k in ("smplx2flame_ind", "left_hand_ind", "right_hand_ind")}
    out.update({k: torch.as_tensor(np.asarray(getattr(extras, k)), dtype=torch.float32,
                                   device=device)
                for k in ("head_center", "left_hand_center", "right_hand_center")})
    return out
