"""Synthetic SMPL-X/FLAME-like assets for tests and benchmarks (numpy copy of
`guava_renderer_tpu/bodymodel/synthetic.py`, without its disk cache).

The real SMPL-X 2020 / FLAME 2020 model files are license-gated downloads;
this module builds structurally faithful stand-ins at any scale: a
consistent body+head pair, the 55-joint SMPL-X kinematic tree, a UV chart
and hand / head vertex maps. The numpy RNG draws follow the JAX package's
order, so one seed gives the same rig in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .data import ParametricModelData, SmplxExtras, uv_face_tables, vertex_uv_from_chart
from .ehm import J_JAW, J_LEYE, J_NECK, J_REYE
from .teeth import graft_teeth, graft_teeth_model

# Standard SMPL-X 55-joint kinematic tree (public model layout).
SMPLX_PARENTS = np.array(
    [
        -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19, 15, 15, 15,
        # left hand: index, middle, pinky, ring, thumb (3 links each)
        20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
        # right hand
        21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
    ],
    np.int32,
)
FLAME_PARENTS = np.array([-1, 0, 1, 1, 1], np.int32)


def _grid_mesh(nx: int, ny: int, scale=(1.0, 1.0), offset=(0.0, 0.0, 0.0)):
    """Regular triangulated grid in the xy plane: verts (nx*ny, 3), faces."""
    xs = np.linspace(-0.5, 0.5, nx) * scale[0] + offset[0]
    ys = np.linspace(-0.5, 0.5, ny) * scale[1] + offset[1]
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([gx, gy, np.full_like(gx, offset[2])], axis=-1).reshape(-1, 3)
    faces = []
    for r in range(ny - 1):
        for c in range(nx - 1):
            i = r * nx + c
            faces.append([i, i + 1, i + nx])
            faces.append([i + 1, i + nx + 1, i + nx])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _soft_weights(verts: np.ndarray, joints: np.ndarray, sharp: float = 40.0) -> np.ndarray:
    d2 = ((verts[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-sharp * d2)
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def _regressor(verts: np.ndarray, joints: np.ndarray, k: int = 8) -> np.ndarray:
    """k-NN average regressor rows so J_reg @ v_template ~= joints."""
    J = np.zeros((joints.shape[0], verts.shape[0]), np.float32)
    for j in range(joints.shape[0]):
        idx = np.argsort(((verts - joints[j]) ** 2).sum(-1))[:k]
        J[j, idx] = 1.0 / k
    return J


def synthetic_model(
    name: str,
    n_verts_side: int,
    joints: np.ndarray,
    parents: np.ndarray,
    n_shape: int,
    n_exp: int,
    seed: int = 0,
    extent=(1.0, 2.0),
    offset=(0.0, 0.0, 0.0),
) -> ParametricModelData:
    rng = np.random.default_rng(seed)
    verts, faces = _grid_mesh(n_verts_side, n_verts_side, extent, offset)
    V, J = verts.shape[0], joints.shape[0]
    shapedirs = (rng.normal(size=(V, 3, n_shape + n_exp)) * 0.003).astype(np.float32)
    posedirs = (rng.normal(size=(V, 3, (J - 1) * 9)) * 0.0005).astype(np.float32)
    return ParametricModelData(
        name=name,
        v_template=verts,
        faces=faces,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=_regressor(verts, joints),
        parents=parents,
        lbs_weights=_soft_weights(verts, joints),
        n_shape=n_shape,
        n_exp=n_exp,
        l_eyelid=np.zeros((V, 3), np.float32),
        r_eyelid=np.zeros((V, 3), np.float32),
    )


def synthetic_ehm(
    body_side: int = 24,
    head_side: int = 10,
    n_shape: int = 20,
    n_exp: int = 10,
    uv_size: int = 64,
    add_teeth: bool = True,
    seed: int = 0,
) -> tuple[ParametricModelData, ParametricModelData, SmplxExtras]:
    """Build a consistent (smplx_data, flame_data, extras) triple.

    The head region of the body mesh IS the flame mesh translated by
    `head_offset`, and the body's eye-joint regressor rows mirror flame's,
    so the EHM graft is near-identity at neutral pose.
    """
    rng = np.random.default_rng(seed)

    # --- flame: small grid "head" at origin, 5 joints ---
    flame_joints = np.array(
        [
            [0.0, -0.1, 0.0],    # global/root
            [0.0, -0.05, 0.0],   # neck
            [0.0, 0.0, 0.02],    # jaw
            [-0.05, 0.05, 0.0],  # left eye
            [0.05, 0.05, 0.0],   # right eye
        ],
        np.float32,
    )
    flame = synthetic_model(
        "flame", head_side, flame_joints, FLAME_PARENTS, n_shape, n_exp,
        seed=seed + 1, extent=(0.3, 0.3),
    )
    eyelid_scale = 0.01
    flame = dataclasses.replace(
        flame,
        l_eyelid=(rng.normal(size=(flame.num_vertices, 3)) * eyelid_scale).astype(np.float32),
        r_eyelid=(rng.normal(size=(flame.num_vertices, 3)) * eyelid_scale).astype(np.float32),
    )

    # --- smplx: body grid + head block placed above ---
    head_offset = np.array([0.0, 1.2, 0.0], np.float32)
    body_verts, body_faces = _grid_mesh(body_side, body_side, (0.8, 1.6))
    Vb = body_verts.shape[0]
    Vf = flame.num_vertices
    verts = np.concatenate([body_verts, flame.v_template + head_offset])
    faces = np.concatenate([body_faces, flame.faces + Vb])
    smplx2flame_ind = np.arange(Vb, Vb + Vf, dtype=np.int32)

    # 55 joints spread through the body; eyes/jaw/neck placed consistently
    # with the flame joints + head_offset so the graft anchor is exact
    joints = np.zeros((55, 3), np.float32)
    t = np.linspace(-0.8, 0.8, 55)
    joints[:, 0] = np.sin(t * 3.0) * 0.3
    joints[:, 1] = t
    joints[J_NECK] = flame_joints[1] + head_offset
    joints[J_JAW] = flame_joints[2] + head_offset
    joints[J_LEYE] = flame_joints[3] + head_offset
    joints[J_REYE] = flame_joints[4] + head_offset

    V, J = verts.shape[0], 55
    weights = _soft_weights(verts, joints, sharp=20.0)
    J_reg = _regressor(verts, joints)
    # the eye/jaw/neck rows read only head vertices so grafting moves them
    for jj, fj in ((J_NECK, 1), (J_JAW, 2), (J_LEYE, 3), (J_REYE, 4)):
        row = np.zeros(V, np.float32)
        row[Vb:Vb + Vf] = flame.J_regressor[fj]
        J_reg[jj] = row

    shapedirs = np.zeros((V, 3, n_shape + n_exp), np.float32)
    shapedirs[:Vb] = rng.normal(size=(Vb, 3, n_shape + n_exp)) * 0.003
    shapedirs[Vb:] = flame.shapedirs  # head region shares flame's shape space
    posedirs = (rng.normal(size=(V, 3, (J - 1) * 9)) * 0.0002).astype(np.float32)
    l_eyelid = np.zeros((V, 3), np.float32)
    r_eyelid = np.zeros((V, 3), np.float32)
    l_eyelid[Vb:] = flame.l_eyelid
    r_eyelid[Vb:] = flame.r_eyelid

    smplx = ParametricModelData(
        name="smplx",
        v_template=verts.astype(np.float32),
        faces=faces,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_reg,
        parents=SMPLX_PARENTS,
        lbs_weights=weights,
        n_shape=n_shape,
        n_exp=n_exp,
        l_eyelid=l_eyelid,
        r_eyelid=r_eyelid,
    )

    # hands: two small corner patches of the body grid
    left_hand_ind = np.arange(0, 12, dtype=np.int32)
    right_hand_ind = np.arange(body_side - 4, body_side + 8, dtype=np.int32)

    # UV chart: body and head side by side in texture space
    tex_body = _uv_for_grid(body_side, body_side, (0.02, 0.02), (0.55, 0.96))
    tex_head = _uv_for_grid(head_side, head_side, (0.62, 0.02), (0.36, 0.36))
    texcoords = np.concatenate([tex_body, tex_head])
    faces_uv_idx = faces.copy()  # 1:1 vertex<->texcoord

    extras = SmplxExtras(
        smplx2flame_ind=smplx2flame_ind,
        left_hand_ind=left_hand_ind,
        right_hand_ind=right_hand_ind,
        head_center=verts[smplx2flame_ind].mean(0),
        left_hand_center=verts[left_hand_ind].mean(0),
        right_hand_center=verts[right_hand_ind].mean(0),
        texcoords=texcoords,
        faces_uv_idx=faces_uv_idx,
    )

    if add_teeth:
        n_ring = 8
        # lip rings: two adjacent rows near the middle of the head grid
        mid = head_side // 2
        upper = (np.arange(n_ring) + mid * head_side + 1).astype(np.int32)
        lower = (upper + head_side).astype(np.int32)
        flame, _ = graft_teeth_model(flame, upper, lower, upper_joint=1, lower_joint=2)
        smplx, extras = graft_teeth(smplx, extras, {"upper": upper, "lower": lower})

    fidx, fbary, fmask = uv_face_tables(extras.texcoords, extras.faces_uv_idx, uv_size)
    extras = dataclasses.replace(
        extras,
        uvmap_f_idx=fidx,
        uvmap_f_bary=fbary,
        uvmap_mask=fmask,
        vertex_uv_coord=vertex_uv_from_chart(
            smplx.num_vertices, smplx.faces, extras.faces_uv_idx, extras.texcoords
        ),
    )
    return smplx, flame, extras


def _uv_for_grid(nx, ny, origin, size):
    u = np.linspace(0, 1, nx) * size[0] + origin[0]
    v = np.linspace(0, 1, ny) * size[1] + origin[1]
    gu, gv = np.meshgrid(u, v, indexing="xy")
    return np.stack([gu, gv], -1).reshape(-1, 2).astype(np.float32)
