"""EHM - Expressive Human Model, SMPL-X body + FLAME head hybrid
(counterpart of `guava_renderer_tpu/bodymodel/ehm.py`).

1. FLAME branch: zero global+neck pose, LBS with shape+expr+jaw+eye, add
   eyelid blendshapes, apply per-axis head_scale about the FLAME origin.
2. SMPL-X branch: shape blendshapes -> template; per-identity joints_offset.
3. Graft the posed FLAME head into the shaped body template, anchored by the
   mean eye joints, then apply hand_scale about the template hand centroids.
4. LBS on the fused template -> vertices, per-vertex 4x4 transforms and
   per-joint transforms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lbs as lbs_core
from ..core.rotations import axis_angle_to_matrix
from ..device import resolve_device

# SMPL-X joint ids (public kinematic layout)
J_NECK, J_LWRIST, J_RWRIST, J_JAW, J_LEYE, J_REYE = 12, 20, 21, 22, 23, 24
# FLAME joint ids
F_NECK, F_JAW, F_LEYE, F_REYE = 1, 2, 3, 4


class BodyParams(NamedTuple):
    """SMPL-X-side inputs. Poses are (B, n, 3) axis-angle or (B, n, 3, 3) rotmats."""

    shape: torch.Tensor
    body_pose: torch.Tensor                       # (B, 21, ...)
    global_pose: torch.Tensor | None = None       # (B, 1, ...)
    left_hand_pose: torch.Tensor | None = None    # (B, 15, ...)
    right_hand_pose: torch.Tensor | None = None   # (B, 15, ...)
    exp: torch.Tensor | None = None               # (B, n_exp)
    joints_offset: torch.Tensor | None = None     # (B, 55, 3)
    head_scale: torch.Tensor | None = None        # (B, 3) or (B, 1)
    hand_scale: torch.Tensor | None = None        # (B, 3) or (B, 1)
    static_offset: torch.Tensor | None = None     # (B, V, 3)


class FlameParams(NamedTuple):
    """FLAME-side inputs; poses are axis-angle."""

    shape: torch.Tensor
    exp: torch.Tensor                             # (B, n_exp)
    jaw: torch.Tensor                             # (B, 3)
    eyes: torch.Tensor | None = None              # (B, 6) [left, right]
    eyelids: torch.Tensor | None = None           # (B, 2) [left, right]


class EhmResult(NamedTuple):
    vertices: torch.Tensor            # (B, V, 3)
    joints_rest: torch.Tensor         # (B, 55, 3)
    joints_posed: torch.Tensor        # (B, 55, 3)
    vertex_transforms: torch.Tensor   # (B, V, 4, 4)
    joint_transforms: torch.Tensor    # (B, 55, 4, 4)
    template: torch.Tensor            # (B, V, 3) fused rest template


class EhmModel(NamedTuple):
    """Frozen EHM assets: device tensors + static host metadata."""

    smplx: dict
    flame: dict
    smplx_parents: tuple
    flame_parents: tuple
    smplx2flame_ind: torch.Tensor     # (Vf,) int64
    left_hand_ind: torch.Tensor
    right_hand_ind: torch.Tensor
    left_hand_center: torch.Tensor    # (3,)
    right_hand_center: torch.Tensor
    n_shape: int
    n_exp: int

    @staticmethod
    def build(smplx_data, flame_data, extras, device="cuda") -> "EhmModel":
        """From the numpy assets (`bodymodel.data`); grafts the FLAME head
        template into the SMPL-X template once, at the mean eye joints."""
        dev = resolve_device(device)
        smplx = smplx_data.torch(dev)
        flame = flame_data.torch(dev)
        body_j = lbs_core.vertices2joints(smplx["J_regressor"], smplx["v_template"][None])[0]
        flame_j = lbs_core.vertices2joints(flame["J_regressor"], flame["v_template"][None])[0]
        anchor = body_j[J_LEYE:J_REYE + 1].mean(0) - flame_j[F_LEYE:F_REYE + 1].mean(0)
        s2f = torch.as_tensor(extras.smplx2flame_ind, dtype=torch.int64, device=dev)
        v_t = smplx["v_template"].clone()
        v_t[s2f] = flame["v_template"] + anchor
        smplx["v_template"] = v_t

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        def i64(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev)

        return EhmModel(
            smplx=smplx,
            flame=flame,
            smplx_parents=tuple(int(p) for p in smplx_data.parents),
            flame_parents=tuple(int(p) for p in flame_data.parents),
            smplx2flame_ind=s2f,
            left_hand_ind=i64(extras.left_hand_ind),
            right_hand_ind=i64(extras.right_hand_ind),
            left_hand_center=f32(extras.left_hand_center),
            right_hand_center=f32(extras.right_hand_center),
            n_shape=int(smplx_data.n_shape),
            n_exp=int(smplx_data.n_exp),
        )


def _pad_shape(shape: torch.Tensor, n: int) -> torch.Tensor:
    if shape.shape[-1] < n:
        pad = shape.new_zeros(shape.shape[:-1] + (n - shape.shape[-1],))
        return torch.cat([shape, pad], dim=-1)
    return shape[..., :n]


def _as_rotmats(pose: torch.Tensor) -> torch.Tensor:
    """(B, n, 3) axis-angle or (B, n, 3, 3) rotmats -> rotmats."""
    return pose if pose.ndim == 4 else axis_angle_to_matrix(pose)


def _maybe_pose(pose, B, n, device):
    if pose is None:
        return torch.eye(3, device=device).expand(B, n, 3, 3)
    return _as_rotmats(pose)


def flame_branch(model: EhmModel, fp: FlameParams, B: int) -> tuple[torch.Tensor, torch.Tensor]:
    """FLAME head LBS with global+neck zeroed.

    Returns (head_vertices (B, Vf, 3), head_joints (B, 5, 3) posed)."""
    flame = model.flame
    dev = fp.exp.device
    betas = torch.cat([_pad_shape(fp.shape, model.n_shape), fp.exp], dim=-1)
    eyes = fp.eyes if fp.eyes is not None else torch.zeros((B, 6), device=dev)
    pose_aa = torch.cat(
        [torch.zeros((B, 6), device=dev), fp.jaw.reshape(B, 3), eyes.reshape(B, 6)],
        dim=-1,
    ).reshape(B, 5, 3)
    res = lbs_core.lbs(
        pose_aa,
        flame["v_template"],
        None,
        model.flame_parents,
        flame["lbs_weights"],
        betas=betas,
        shapedirs=flame["shapedirs"],
        posedirs=flame["posedirs"],
        J_regressor=flame["J_regressor"],
    )
    verts = res.vertices
    if fp.eyelids is not None and "l_eyelid" in flame:
        verts = verts + flame["r_eyelid"][None] * fp.eyelids[:, 1, None, None]
        verts = verts + flame["l_eyelid"][None] * fp.eyelids[:, 0, None, None]
    return verts, res.joints_posed


def ehm_forward(model: EhmModel, body: BodyParams, flame: FlameParams | None = None) -> EhmResult:
    """Full EHM deformation."""
    smplx = model.smplx
    B = body.shape.shape[0]
    dev = body.shape.device

    head_verts = None
    if flame is not None:
        head_verts, head_joints = flame_branch(model, flame, B)
        if body.head_scale is not None:
            head_verts = head_verts * body.head_scale[:, None]

    exp = body.exp if body.exp is not None else torch.zeros((B, model.n_exp), device=dev)
    shape_components = torch.cat([_pad_shape(body.shape, model.n_shape), exp], dim=-1)
    eye_jaw = torch.eye(3, device=dev).expand(B, 3, 3, 3)  # jaw + 2 eyes zeroed
    full_pose = torch.cat(
        [
            _maybe_pose(body.global_pose, B, 1, dev),
            _as_rotmats(body.body_pose),
            eye_jaw,
            _maybe_pose(body.left_hand_pose, B, 15, dev),
            _maybe_pose(body.right_hand_pose, B, 15, dev),
        ],
        dim=1,
    )  # (B, 55, 3, 3)

    template = smplx["v_template"][None] + lbs_core.blend_shapes(shape_components, smplx["shapedirs"])
    if body.static_offset is not None:
        template = template + body.static_offset
    tbody_joints = lbs_core.vertices2joints(smplx["J_regressor"], template)
    if body.joints_offset is not None:
        tbody_joints = tbody_joints + body.joints_offset

    # graft the posed FLAME head into the shaped template
    if head_verts is not None:
        anchor = tbody_joints[:, J_LEYE:J_REYE + 1].mean(1, keepdim=True) - head_joints[
            :, F_LEYE:F_REYE + 1
        ].mean(1, keepdim=True)
        template = template.clone()
        template[:, model.smplx2flame_ind] = head_verts + anchor

    # hand scale about the template hand centroids
    if body.hand_scale is not None:
        hs = body.hand_scale[:, None]
        template = template.clone()
        for ind, center in (
            (model.left_hand_ind, model.left_hand_center),
            (model.right_hand_ind, model.right_hand_center),
        ):
            template[:, ind] = template[:, ind] * hs + (1.0 - hs) * center[None, None]

    # LBS on the fused template (rest joints re-regressed from it)
    joints_rest = lbs_core.vertices2joints(smplx["J_regressor"], template)
    if body.joints_offset is not None:
        joints_rest = joints_rest + body.joints_offset
    res = lbs_core.lbs(
        full_pose,
        template,
        joints_rest,
        model.smplx_parents,
        smplx["lbs_weights"],
        posedirs=smplx["posedirs"],
        pose2rot=False,
    )
    return EhmResult(
        vertices=res.vertices,
        joints_rest=joints_rest,
        joints_posed=res.joints_posed,
        vertex_transforms=res.vertex_transforms,
        joint_transforms=res.joint_transforms,
        template=template,
    )


def head_hand_subsets(model: EhmModel, result: EhmResult) -> dict[str, torch.Tensor]:
    """The head and hand vertices with their reference joints."""
    return {
        "head_vertices": result.vertices[:, model.smplx2flame_ind],
        "head_ref_joint": result.joints_rest[:, J_LEYE:J_REYE + 1].mean(1, keepdim=True),
        "left_hand_vertices": result.vertices[:, model.left_hand_ind],
        "left_hand_ref_joint": result.joints_rest[:, J_LWRIST:J_LWRIST + 1],
        "right_hand_vertices": result.vertices[:, model.right_hand_ind],
        "right_hand_ref_joint": result.joints_rest[:, J_RWRIST:J_RWRIST + 1],
    }


def ehm_transform_mats(
    model: EhmModel,
    body: BodyParams,
    jaw: torch.Tensor | None = None,
    eyes: torch.Tensor | None = None,
    mirror_left_hand: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-joint transforms for external motion retargeting: the 55-joint
    pose from the body, hand and FLAME jaw/eye channels ->
    (joint_transforms (B, 55, 4, 4), joints_posed (B, 55, 3)).
    `mirror_left_hand` mirrors left-hand axis-angles, for motion sources
    whose left hands come mirrored."""
    B = body.shape.shape[0]
    dev = body.shape.device
    lhand = body.left_hand_pose
    if lhand is not None and mirror_left_hand and lhand.ndim == 3:
        lhand = lhand * lhand.new_tensor([1.0, -1.0, -1.0])
    jaw_m = _as_rotmats(jaw.reshape(B, 1, 3)) if jaw is not None else _maybe_pose(None, B, 1, dev)
    eyes_m = (_as_rotmats(eyes.reshape(B, 2, 3)) if eyes is not None
              else _maybe_pose(None, B, 2, dev))
    full_pose = torch.cat([
        _maybe_pose(body.global_pose, B, 1, dev),
        _as_rotmats(body.body_pose),
        jaw_m,
        eyes_m,
        _maybe_pose(lhand, B, 15, dev),
        _maybe_pose(body.right_hand_pose, B, 15, dev),
    ], dim=1)

    smplx = model.smplx
    exp = body.exp if body.exp is not None else torch.zeros((B, model.n_exp), device=dev)
    shape_components = torch.cat([_pad_shape(body.shape, model.n_shape), exp], dim=-1)
    template = smplx["v_template"][None] + lbs_core.blend_shapes(shape_components,
                                                                 smplx["shapedirs"])
    joints = lbs_core.vertices2joints(smplx["J_regressor"], template)
    if body.joints_offset is not None:
        joints = joints + body.joints_offset
    posed, rel = lbs_core.rigid_transform_chain(full_pose, joints, model.smplx_parents)
    return rel, posed
