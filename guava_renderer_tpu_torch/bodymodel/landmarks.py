"""Facial landmark embeddings: static FAN-51, the yaw-dynamic 17-point
contour, MediaPipe-105 and the 203-point set (counterpart of
`guava_renderer_tpu/bodymodel/landmarks.py`).

The 17 jaw-contour landmarks follow the silhouette as the head turns: the
model ships a table with one (face id, barycentric) row per degree of head
yaw in [-39, +39]; the forward composes the head's kinematic chain, reads its
yaw and gathers that row. The tables are tensors on an explicit device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.lbs import vertices2landmarks
from ..core.rotations import axis_angle_to_matrix

# pelvis -> spine1/2/3 -> neck -> head, leaf first
SMPLX_HEAD_KIN_CHAIN = (15, 12, 9, 6, 3, 0)
# FLAME: neck (joint 1) up to the root
FLAME_NECK_KIN_CHAIN = (1, 0)


class LandmarkTables(NamedTuple):
    """Static and yaw-dynamic landmark embeddings of one parametric model:
    row b of the dynamic table holds the contour for a head yaw of bucket b
    (0..39 = 0..+39 degrees, 40..78 = -1..-39)."""

    static_faces_idx: torch.Tensor      # (Ls,) int32
    static_bary_coords: torch.Tensor    # (Ls, 3) f32
    dynamic_faces_idx: torch.Tensor     # (79, Ld) int32
    dynamic_bary_coords: torch.Tensor   # (79, Ld, 3) f32
    head_kin_chain: tuple = SMPLX_HEAD_KIN_CHAIN


class StaticEmbedding(NamedTuple):
    """A fixed embedding, e.g. MediaPipe-105 or the 203-point set."""

    faces_idx: torch.Tensor             # (L,) int32
    bary_coords: torch.Tensor           # (L, 3) f32


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32), device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def rot_mat_to_yaw(R: torch.Tensor) -> torch.Tensor:
    """Y-axis euler angle of (..., 3, 3) rotations."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    return torch.atan2(-R[..., 2, 0], sy)


def head_yaw_bucket(full_pose_aa: torch.Tensor, head_kin_chain) -> torch.Tensor:
    """(B, J, 3) axis-angle full pose -> (B,) int64 bucket in [0, 78]:
    0..39 are yaws 0..+39 degrees, 40..78 are -1..-39, and |yaw| > 39
    clamps to the extreme bucket."""
    chain = torch.as_tensor(head_kin_chain, device=full_pose_aa.device)
    rots = axis_angle_to_matrix(full_pose_aa[:, chain])          # (B, K, 3, 3), leaf first
    rel = torch.eye(3, dtype=full_pose_aa.dtype,
                    device=full_pose_aa.device).expand(full_pose_aa.shape[0], 3, 3)
    for i in range(len(head_kin_chain)):
        rel = torch.einsum("bij,bjk->bik", rots[:, i], rel)
    # the table's angle is -yaw, clamped above at +39
    y = torch.round(torch.clamp(-rot_mat_to_yaw(rel) * 180.0 / np.pi, max=39.0)).to(torch.int64)
    neg = torch.where(y < -39, torch.full_like(y, 78), 39 - y)
    return torch.where(y < 0, neg, y)


def dynamic_landmark_tables(full_pose_aa: torch.Tensor,
                            tables: LandmarkTables) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch contour (faces_idx (B, Ld), bary (B, Ld, 3)) from the yaw table."""
    bucket = head_yaw_bucket(full_pose_aa, tables.head_kin_chain)
    return tables.dynamic_faces_idx[bucket], tables.dynamic_bary_coords[bucket]


def face_landmarks_68(vertices: torch.Tensor, faces: torch.Tensor, tables: LandmarkTables,
                      full_pose_aa: torch.Tensor) -> torch.Tensor:
    """FAN-68 landmarks: the 17 yaw-dynamic contour points, then the 51
    static inner-face points. (B, V, 3) -> (B, 68, 3)."""
    dyn_f, dyn_b = dynamic_landmark_tables(full_pose_aa, tables)
    B = vertices.shape[0]
    stat_f = tables.static_faces_idx[None].expand(B, -1)
    stat_b = tables.static_bary_coords[None].expand(B, -1, -1)
    return vertices2landmarks(vertices, faces, torch.cat([dyn_f, stat_f], 1),
                              torch.cat([dyn_b, stat_b], 1))


def embedded_landmarks(vertices: torch.Tensor, faces: torch.Tensor,
                       emb: StaticEmbedding) -> torch.Tensor:
    """Static embedding extraction (MediaPipe-105 / 203-point sets)."""
    return vertices2landmarks(vertices, faces, emb.faces_idx, emb.bary_coords)


# ---------------------------------------------------------------------------
# loaders (numpy in, tensors on `device` out)
# ---------------------------------------------------------------------------


def landmark_tables_from_smplx_npz(ss, head_kin_chain=SMPLX_HEAD_KIN_CHAIN,
                                   device="cuda") -> LandmarkTables:
    """Tables from the SMPL-X model npz keys. Some releases store 17 + 51
    static rows; the static part used with the dynamic contour is the last 51."""
    from ..device import resolve_device

    dev = resolve_device(device)
    stat_f = np.asarray(ss["lmk_faces_idx"], np.int64)
    stat_b = np.asarray(ss["lmk_bary_coords"], np.float32)
    if stat_f.shape[0] == 68:  # the dynamic contour replaces the static one
        stat_f, stat_b = stat_f[17:], stat_b[17:]
    return LandmarkTables(
        static_faces_idx=_i32(stat_f, dev),
        static_bary_coords=_f32(stat_b, dev),
        dynamic_faces_idx=_i32(ss["dynamic_lmk_faces_idx"], dev),
        dynamic_bary_coords=_f32(ss["dynamic_lmk_bary_coords"], dev),
        head_kin_chain=tuple(head_kin_chain),
    )


def landmark_tables_from_flame_npy(path: str,
                                   device="cuda") -> tuple[LandmarkTables, StaticEmbedding]:
    """FLAME `landmark_embedding.npy` (a pickled dict, read through the asset
    unpickler) -> (tables of the 17 + 51 FAN set, the 68-point `full` static
    embedding)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    with open(path, "rb") as f:
        d = _npy_object(f)
    tables = LandmarkTables(
        static_faces_idx=_i32(d["static_lmk_faces_idx"], dev),
        static_bary_coords=_f32(d["static_lmk_bary_coords"], dev),
        dynamic_faces_idx=_i32(d["dynamic_lmk_faces_idx"], dev),
        dynamic_bary_coords=_f32(d["dynamic_lmk_bary_coords"], dev),
        head_kin_chain=FLAME_NECK_KIN_CHAIN,
    )
    full = StaticEmbedding(
        faces_idx=_i32(np.asarray(d["full_lmk_faces_idx"]).reshape(-1), dev),
        bary_coords=_f32(np.asarray(d["full_lmk_bary_coords"]).reshape(-1, 3), dev),
    )
    return tables, full


def _npy_object(f) -> dict:
    """The pickled object of a .npy file of dtype object, unpickled by
    `AssetUnpickler` rather than `np.load(allow_pickle=True)`."""
    from .data import AssetUnpickler

    fmt = np.lib.format
    version = fmt.read_magic(f)
    read_header = {(1, 0): fmt.read_array_header_1_0, (2, 0): fmt.read_array_header_2_0}
    if version not in read_header:
        raise ValueError(f"{getattr(f, 'name', f)}: .npy format {version} is not read here")
    shape, _, dtype = read_header[version](f)
    if dtype.hasobject:
        obj = AssetUnpickler(f, encoding="latin1").load()
        return obj[()] if isinstance(obj, np.ndarray) else obj
    raise ValueError(f"{getattr(f, 'name', f)} holds a plain array of shape {shape}, "
                     "not a pickled landmark dict")


def load_mediapipe_embedding(path: str, device="cuda") -> tuple[StaticEmbedding, np.ndarray]:
    """mediapipe_landmark_embedding.npz -> (embedding, landmark indices into
    the 478 MediaPipe points)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    d = np.load(path)
    emb = StaticEmbedding(faces_idx=_i32(d["lmk_face_idx"], dev),
                          bary_coords=_f32(d["lmk_b_coords"], dev))
    return emb, np.asarray(d["landmark_indices"])


def load_203_embedding(path: str, device="cuda") -> tuple[StaticEmbedding, dict]:
    """203_landmark_embeding.npz -> (embedding, view-subset index dict)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    d = np.load(path)
    emb = StaticEmbedding(faces_idx=_i32(d["lmk_face_idx"], dev),
                          bary_coords=_f32(d["lmk_b_coords"], dev))
    subsets = {
        k[len("landmark_"):-len("_indices")]: np.asarray(d[k])
        for k in d.files
        if k.startswith("landmark_") and k.endswith("_indices")
    }
    return emb, subsets


def synthetic_landmark_tables(num_faces: int, n_static: int = 51, n_contour: int = 17,
                              head_kin_chain=SMPLX_HEAD_KIN_CHAIN, seed: int = 0,
                              device="cuda") -> LandmarkTables:
    """Structure-compatible random tables (the JAX package's draws, in order)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def bary(n):
        b = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
        return b / b.sum(-1, keepdims=True)

    static_f = rng.integers(0, num_faces, n_static, dtype=np.int32)
    static_b = bary(n_static)
    dyn_f = rng.integers(0, num_faces, (79, n_contour), dtype=np.int32)
    dyn_b = bary(79 * n_contour).reshape(79, n_contour, 3)
    return LandmarkTables(
        static_faces_idx=_i32(static_f, dev),
        static_bary_coords=_f32(static_b, dev),
        dynamic_faces_idx=_i32(dyn_f, dev),
        dynamic_bary_coords=_f32(dyn_b, dev),
        head_kin_chain=tuple(head_kin_chain),
    )
