"""Procedural teeth grafting (numpy copy of `guava_renderer_tpu/bodymodel/teeth.py`).

8 rows of N teeth vertices are built from the lip outside rings and bound
to the neck (upper) / jaw (lower) joints; the face triples are three
mirror-symmetric quad strips per jaw.

Row order: 0 upper_root, 1 lower_root, 2 upper_edge, 3 lower_edge,
4 upper_root_back, 5 upper_edge_back, 6 lower_root_back, 7 lower_edge_back.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .data import ParametricModelData, SmplxExtras

ROWS = (
    "upper_root",
    "lower_root",
    "upper_edge",
    "lower_edge",
    "upper_root_back",
    "upper_edge_back",
    "lower_root_back",
    "lower_edge_back",
)
# v-row selector into 7 linspace values, one per row above
_UV_V_ORDER = (3, 2, 0, 1, 3, 4, 6, 5)


def generate_teeth_vertices(
    v_lip_upper: np.ndarray, v_lip_lower: np.ndarray
) -> dict[str, np.ndarray]:
    """The 8 teeth vertex rows from the two lip rings (N, 3)."""
    d = float(np.linalg.norm(v_lip_upper - v_lip_lower, axis=-1).mean())
    middle = (v_lip_upper + v_lip_lower) / 2.0
    middle = middle.copy()
    middle[:, 1] = middle[:, 1].mean()
    middle[:, 2] -= d * 1.5  # set teeth back from the lips

    upper_edge = middle + np.array([0.0, d * 0.1, 0.0])
    upper_root = upper_edge + np.array([0.0, d * 2.0, 0.0])
    lower_edge = middle - np.array([0.0, d * 0.1, 0.0]) - np.array([0.0, 0.0, d * 0.4])
    lower_root = lower_edge - np.array([0.0, d * 2.0, 0.0])

    thickness = np.array([0.0, 0.0, d * 1.0])
    rows = {
        "upper_root": upper_root,
        "lower_root": lower_root,
        "upper_edge": upper_edge,
        "lower_edge": lower_edge,
        "upper_root_back": upper_root - thickness,
        "upper_edge_back": upper_edge - thickness,
        "lower_root_back": lower_root - thickness,
        "lower_edge_back": lower_edge - thickness,
    }
    return {k: rows[k].astype(np.float32) for k in ROWS}


# Quad-split patterns over quad (A=a[i], B=a[i+1], C=b[i], D=b[i+1]).
_P = (("A", "D", "C"), ("A", "B", "D"))
_Q = (("A", "B", "C"), ("B", "D", "C"))
_R = (("A", "C", "D"), ("A", "D", "B"))
_S = (("A", "C", "B"), ("B", "C", "D"))


def _sym_strip(a: np.ndarray, b: np.ndarray, first, second) -> np.ndarray:
    """Mirror-symmetric quad strip: 2(N-1) faces, diagonal flipped from
    `first` to `second` at the center quad."""
    n = len(a)
    faces = []
    for i in range(n - 1):
        v = {"A": a[i], "B": a[i + 1], "C": b[i], "D": b[i + 1]}
        for tri in first if i < (n - 1) // 2 else second:
            faces.append([v[t] for t in tri])
    return np.asarray(faces, np.int32)


def teeth_faces(row_ids: dict[str, np.ndarray]) -> np.ndarray:
    """Three strips per jaw (labial, lingual, occlusal rim)."""
    r = row_ids
    upper = np.concatenate(
        [
            _sym_strip(r["upper_root"], r["upper_edge"], _P, _Q),
            _sym_strip(r["upper_root_back"], r["upper_edge_back"], _R, _S),
            _sym_strip(r["upper_edge_back"], r["upper_edge"], _S, _R),
        ]
    )
    lower = np.concatenate(
        [
            _sym_strip(r["lower_edge"], r["lower_root"], _Q, _P),
            _sym_strip(r["lower_root_back"], r["lower_edge_back"], _P, _Q),
            _sym_strip(r["lower_edge_back"], r["lower_edge"], _Q, _P),
        ]
    )
    return np.concatenate([upper, lower])


def teeth_uv_block(n_cols: int) -> np.ndarray:
    """(8*N, 2) texcoords in the unused top strip of the chart (image-space v)."""
    u = np.linspace(0.1328, 0.2695, n_cols)
    v7 = np.linspace(0.94726, 0.9999, 7)
    rows = [np.stack([u, np.full(n_cols, v7[_UV_V_ORDER[r]])], axis=1) for r in range(8)]
    return np.concatenate(rows).astype(np.float32)


def graft_teeth_model(
    data: ParametricModelData,
    lip_upper_vids: np.ndarray,
    lip_lower_vids: np.ndarray,
    upper_joint: int,
    lower_joint: int,
) -> tuple[ParametricModelData, dict[str, np.ndarray]]:
    """Append teeth geometry and extend every per-vertex model table.

    Returns the new model and the row-name -> new-vertex-ids map.
    """
    V0 = data.num_vertices
    rows = generate_teeth_vertices(
        data.v_template[lip_upper_vids], data.v_template[lip_lower_vids]
    )
    n = len(lip_upper_vids)
    row_ids = {k: np.arange(i * n, (i + 1) * n, dtype=np.int32) + V0 for i, k in enumerate(ROWS)}
    v_teeth = np.concatenate([rows[k] for k in ROWS])
    Vt = v_teeth.shape[0]

    new_faces = teeth_faces(row_ids)

    # teeth follow the mean of the lip rings (shape part only)
    shapedirs_ext = np.zeros((Vt, 3, data.shapedirs.shape[2]), np.float32)
    mean_sd = (
        data.shapedirs[lip_upper_vids, :, : data.n_shape]
        + data.shapedirs[lip_lower_vids, :, : data.n_shape]
    ) / 2.0
    for k in ROWS:
        shapedirs_ext[row_ids[k] - V0, :, : data.n_shape] = mean_sd

    lbs_ext = np.zeros((Vt, data.num_joints), np.float32)
    upper_rows = ("upper_root", "upper_edge", "upper_root_back", "upper_edge_back")
    for k in ROWS:
        j = upper_joint if k in upper_rows else lower_joint
        lbs_ext[row_ids[k] - V0, j] = 1.0

    def ext0(x, axis=0, count=Vt):
        if x is None:
            return None
        shape = list(x.shape)
        shape[axis] = count
        return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)

    new = dataclasses.replace(
        data,
        v_template=np.concatenate([data.v_template, v_teeth]),
        faces=np.concatenate([data.faces, new_faces]),
        shapedirs=np.concatenate([data.shapedirs, shapedirs_ext]),
        posedirs=ext0(data.posedirs),
        J_regressor=ext0(data.J_regressor, axis=1),
        lbs_weights=np.concatenate([data.lbs_weights, lbs_ext]),
        l_eyelid=ext0(data.l_eyelid),
        r_eyelid=ext0(data.r_eyelid),
    )
    return new, row_ids


def graft_teeth(
    data: ParametricModelData,
    extras: SmplxExtras,
    lip_ids_flame: dict[str, np.ndarray],
) -> tuple[ParametricModelData, SmplxExtras]:
    """SMPL-X-level grafting: map FLAME lip ids through smplx2flame_ind,
    graft, then extend the UV chart and the SMPLX<->FLAME index map."""
    lip_upper = extras.smplx2flame_ind[lip_ids_flame["upper"]]
    lip_lower = extras.smplx2flame_ind[lip_ids_flame["lower"]]
    new_data, row_ids = graft_teeth_model(
        data, lip_upper, lip_lower, upper_joint=12, lower_joint=22
    )

    vid_teeth = np.concatenate([row_ids[k] for k in ROWS])
    uv_block = teeth_uv_block(len(lip_upper))
    T0 = extras.texcoords.shape[0]
    # new faces' texcoord ids mirror their vertex ids' offsets into the block
    V0 = data.num_vertices
    new_faces = new_data.faces[data.faces.shape[0]:]
    new_faces_vt = new_faces - V0 + T0

    new_extras = dataclasses.replace(
        extras,
        smplx2flame_ind=np.concatenate(
            [extras.smplx2flame_ind, vid_teeth.astype(np.int32)]
        ),
        texcoords=np.concatenate([extras.texcoords, uv_block]),
        faces_uv_idx=np.concatenate([extras.faces_uv_idx, new_faces_vt.astype(np.int32)]),
    )
    return new_data, new_extras
