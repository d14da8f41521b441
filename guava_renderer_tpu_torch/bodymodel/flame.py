"""FLAME extras: the texture PCA space, the head-index set and the
FLAME-level teeth graft (counterpart of `guava_renderer_tpu/bodymodel/flame.py`).

* texture space: mean + principal components over the FLAME 2020 texture
  chart, stored /255;
* head index: every FLAME vertex id minus an optional lower-head exclusion
  list, the teeth ids appended after a graft;
* `add_teeth_flame`: the teeth rows of `teeth.py` on the FLAME topology,
  upper rows skinned to the neck joint and lower rows to the jaw joint.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .data import ParametricModelData
from .teeth import ROWS, graft_teeth_model, teeth_uv_block

# FLAME joint ids the teeth rows move with
FLAME_NECK_JOINT = 1
FLAME_JAW_JOINT = 2


class FlameTexSpace(NamedTuple):
    """PCA texture space, values in [0, 1] (stored /255)."""

    mean: np.ndarray    # (H*W*3,) f32
    basis: np.ndarray   # (H*W*3, n_pc) f32
    size: int = 512


def load_flame_texture(path: str, n_pc: int = 200) -> FlameTexSpace:
    """FLAME2020/FLAME_texture.npz -> texture space."""
    tex = np.load(path)
    mean = np.asarray(tex["mean"], np.float32).reshape(-1) / 255.0
    basis = np.asarray(tex["tex_dir"], np.float32).reshape(-1, n_pc)[:, :n_pc] / 255.0
    size = int(round((mean.shape[0] / 3) ** 0.5))
    return FlameTexSpace(mean=mean, basis=basis, size=size)


def synthetic_flame_texture(size: int = 16, n_pc: int = 8, seed: int = 0) -> FlameTexSpace:
    rng = np.random.default_rng(seed)
    return FlameTexSpace(
        mean=rng.uniform(0.2, 0.8, size * size * 3).astype(np.float32),
        basis=(rng.normal(size=(size * size * 3, n_pc)) * 0.05).astype(np.float32),
        size=size,
    )


def flame_texture(tex_params: torch.Tensor, space: FlameTexSpace) -> torch.Tensor:
    """(B, n_pc) PCA coefficients -> (B, H, W, 3) albedo in [0, 1], on the
    coefficients' device."""
    dev = tex_params.device
    mean = torch.as_tensor(space.mean, device=dev)
    n = tex_params.shape[-1]
    basis = torch.as_tensor(space.basis[:, :n], device=dev)
    flat = mean[None] + tex_params @ basis.T
    return torch.clamp(flat.reshape(tex_params.shape[0], space.size, space.size, 3), 0.0, 1.0)


def flame_head_index(num_vertices: int, lowerhead_mask_path: str | None = None) -> np.ndarray:
    """Head vertex-id set: every id minus the lower-head exclusion list."""
    idx = np.arange(num_vertices, dtype=np.int64)
    if lowerhead_mask_path and os.path.exists(lowerhead_mask_path):
        idx = idx[~np.isin(idx, np.load(lowerhead_mask_path))]
    return idx


def add_teeth_flame(
    data: ParametricModelData,
    texcoords: np.ndarray | None = None,
    faces_uv_idx: np.ndarray | None = None,
    head_index: np.ndarray | None = None,
):
    """FLAME-level teeth graft: appends the 8 x 15 teeth rows to the FLAME
    template (upper rows on the neck joint, lower rows on the jaw joint),
    extends the UV chart with the teeth strip and appends the new ids to
    head_index.

    Returns (new_data, info) with 'row_ids', 'vid_teeth', 'vid_teeth_upper',
    'vid_teeth_lower', 'head_index' and, given a chart, 'texcoords' and
    'faces_uv_idx'."""
    from .flame_regions import LIP_OUTSIDE_RING_LOWER, LIP_OUTSIDE_RING_UPPER

    new_data, row_ids = graft_teeth_model(
        data,
        np.asarray(LIP_OUTSIDE_RING_UPPER),
        np.asarray(LIP_OUTSIDE_RING_LOWER),
        upper_joint=FLAME_NECK_JOINT,
        lower_joint=FLAME_JAW_JOINT,
    )
    upper_rows = ("upper_root", "upper_edge", "upper_root_back", "upper_edge_back")
    info = {
        "row_ids": row_ids,
        "vid_teeth": np.concatenate([row_ids[k] for k in ROWS]),
        "vid_teeth_upper": np.concatenate([row_ids[k] for k in ROWS if k in upper_rows]),
        "vid_teeth_lower": np.concatenate([row_ids[k] for k in ROWS if k not in upper_rows]),
    }
    if head_index is None:
        head_index = np.arange(data.num_vertices, dtype=np.int64)
    info["head_index"] = np.concatenate([head_index, info["vid_teeth"].astype(np.int64)])

    if texcoords is not None and faces_uv_idx is not None:
        T0, V0 = texcoords.shape[0], data.num_vertices
        new_faces = new_data.faces[data.faces.shape[0]:]
        info["texcoords"] = np.concatenate([texcoords, teeth_uv_block(len(LIP_OUTSIDE_RING_UPPER))])
        info["faces_uv_idx"] = np.concatenate(
            [faces_uv_idx, (new_faces - V0 + T0).astype(np.int32)])
    return new_data, info
