"""Parametric body-model asset schema and the UV-chart tables (numpy).

A copy of what the per-frame path needs from
`guava_renderer_tpu/bodymodel/data.py`. The UV face tables always come from
the vectorized numpy rasterizer (the JAX package prefers cv2 when present).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParametricModelData:
    """Everything LBS needs, as numpy. Convert with .torch() at the device edge."""

    name: str
    v_template: np.ndarray        # (V, 3) f32
    faces: np.ndarray             # (F, 3) i32
    shapedirs: np.ndarray         # (V, 3, n_shape + n_exp) f32
    posedirs: np.ndarray          # (V, 3, (J-1)*9) f32
    J_regressor: np.ndarray       # (J, V) f32
    parents: np.ndarray           # (J,) i32 (parents[0] == -1)
    lbs_weights: np.ndarray       # (V, J) f32
    n_shape: int
    n_exp: int
    l_eyelid: np.ndarray | None = None             # (V, 3) f32
    r_eyelid: np.ndarray | None = None             # (V, 3) f32

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.parents.shape[0]

    def torch(self, device: torch.device) -> dict[str, torch.Tensor]:
        """Dict of f32 tensors of the fields the forward pass reads."""
        keys = ["v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"]
        keys += [k for k in ("l_eyelid", "r_eyelid") if getattr(self, k) is not None]
        return {
            k: torch.as_tensor(np.asarray(getattr(self, k), np.float32), device=device)
            for k in keys
        }


@dataclasses.dataclass(frozen=True)
class SmplxExtras:
    """SMPL-X index maps and UV machinery (static, numpy)."""

    smplx2flame_ind: np.ndarray
    left_hand_ind: np.ndarray
    right_hand_ind: np.ndarray
    head_center: np.ndarray
    left_hand_center: np.ndarray
    right_hand_center: np.ndarray
    texcoords: np.ndarray | None = None          # (T, 2) f32, image-space v
    faces_uv_idx: np.ndarray | None = None       # (F, 3) i32
    uvmap_f_idx: np.ndarray | None = None        # (U, U) i32, -1 = empty
    uvmap_f_bary: np.ndarray | None = None       # (U, U, 3) f32
    uvmap_mask: np.ndarray | None = None         # (U, U) bool
    vertex_uv_coord: np.ndarray | None = None    # (V, 2) f32


def uv_face_tables(
    texcoords: np.ndarray,
    faces_vt: np.ndarray,
    uv_size: int = 512,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rasterize the UV chart: per-texel face id + barycentrics.

    Vertex coords are round(uv * uv_size) integers, triangles are filled
    boundary-inclusive, and on overlap the later face wins. Barycentrics are
    clamped non-negative and renormalized.

    Returns (face_idx (U,U) i32 with -1 empty, bary (U,U,3) f32, mask (U,U) bool).
    """
    U = uv_size
    tri = np.round(texcoords[faces_vt] * U).astype(np.float64)  # (F, 3, 2)
    face_idx = np.full((U, U), -1, np.int32)
    bary_map = np.zeros((U, U, 3), np.float32)

    x0 = np.clip(np.floor(tri[..., 0].min(1)).astype(np.int64), 0, U - 1)
    x1 = np.clip(np.ceil(tri[..., 0].max(1)).astype(np.int64), 0, U - 1)
    y0 = np.clip(np.floor(tri[..., 1].min(1)).astype(np.int64), 0, U - 1)
    y1 = np.clip(np.ceil(tri[..., 1].max(1)).astype(np.int64), 0, U - 1)

    # faces grouped by bbox size so each group is one vectorized op
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    max_w, max_h = int(w.max()), int(h.max())

    hits_y, hits_x, hits_f, hits_b = [], [], [], []
    for fw in range(1, max_w + 1):
        for fh in range(1, max_h + 1):
            sel = np.nonzero((w == fw) & (h == fh))[0]
            if sel.size == 0:
                continue
            gx = x0[sel][:, None, None] + np.arange(fw)[None, None, :]
            gy = y0[sel][:, None, None] + np.arange(fh)[None, :, None]
            gx = np.broadcast_to(np.minimum(gx, U - 1), (sel.size, fh, fw))
            gy = np.broadcast_to(np.minimum(gy, U - 1), (sel.size, fh, fw))
            px = gx.astype(np.float64)
            py = gy.astype(np.float64)
            a, b, c = tri[sel, 0], tri[sel, 1], tri[sel, 2]
            det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
                b[:, 1] - a[:, 1]
            ) * (c[:, 0] - a[:, 0])
            det = np.where(np.abs(det) < 1e-12, 1e-12, det)[:, None, None]
            w0 = (
                (b[:, 0, None, None] - px) * (c[:, 1, None, None] - py)
                - (b[:, 1, None, None] - py) * (c[:, 0, None, None] - px)
            ) / det
            w1 = (
                (c[:, 0, None, None] - px) * (a[:, 1, None, None] - py)
                - (c[:, 1, None, None] - py) * (a[:, 0, None, None] - px)
            ) / det
            w2 = 1.0 - w0 - w1
            # boundary-inclusive, half-texel tolerance scaled to the triangle
            eps = -0.5 / max(fw, fh)
            inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
            fi, yi, xi = np.nonzero(inside)
            bary = np.stack([w0[fi, yi, xi], w1[fi, yi, xi], w2[fi, yi, xi]], axis=-1)
            hits_y.append(gy[fi, yi, xi])
            hits_x.append(gx[fi, yi, xi])
            hits_f.append(sel[fi])
            hits_b.append(bary)

    ys = np.concatenate(hits_y)
    xs = np.concatenate(hits_x)
    fs = np.concatenate(hits_f)
    bs = np.concatenate(hits_b)
    # later faces overwrite earlier ones
    order = np.argsort(fs, kind="stable")
    ys, xs, fs, bs = ys[order], xs[order], fs[order], bs[order]
    bs = np.clip(bs, 0.0, None)
    bs = bs / np.maximum(bs.sum(-1, keepdims=True), 1e-6)
    face_idx[ys, xs] = fs
    bary_map[ys, xs] = bs.astype(np.float32)
    return face_idx, bary_map, face_idx >= 0


def vertex_uv_from_chart(
    num_vertices: int,
    faces_v: np.ndarray,
    faces_vt: np.ndarray,
    texcoords: np.ndarray,
) -> np.ndarray:
    """Per-vertex UV coordinate (first texcoord seen per vertex)."""
    out = np.zeros((num_vertices, 2), np.float32)
    flat_v = faces_v.reshape(-1)
    flat_vt = faces_vt.reshape(-1)
    # reverse order so the first occurrence wins after overwrite
    for v, vt in zip(flat_v[::-1], flat_vt[::-1]):
        out[v] = texcoords[vt]
    return out
