"""Parametric body-model asset schema, the UV-chart tables and the SMPL-X /
FLAME loaders (numpy; counterpart of `guava_renderer_tpu/bodymodel/data.py`).

Assets load into frozen numpy dataclasses and become tensors once, at the
device edge (`ParametricModelData.torch`).

* `uv_face_tables` fills each chart triangle as OpenCV's filled contour
  does (`cv2.drawContours(img, [tri], 0, f, -1)` in face order, the JAX
  package's default), written in numpy: the edges' 8-connected lines, then
  the scanline spans between them, with OpenCV's clipping at the image
  border. The card has no cv2.
* `load_flame` reads FLAME 2020's `generic_model.pkl` without chumpy: its
  pickles go through `AssetUnpickler`, which maps chumpy's array class to a
  stub that keeps the pickled array, lets numpy and `scipy.sparse` through
  and refuses every other class by its module and name.
* posedirs keep the (V, 3, (J-1)*9) layout the LBS einsums read.
"""

from __future__ import annotations

import copyreg
import dataclasses
import os
import pickle

import numpy as np
import torch

# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


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
    # optional landmark embedding
    lmk_faces_idx: np.ndarray | None = None        # (L,) i32
    lmk_bary_coords: np.ndarray | None = None      # (L, 3) f32
    # optional eyelid blendshape deltas, full-V layout
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

    smplx2flame_ind: np.ndarray          # (V_flame,) i32: FLAME vid -> SMPL-X vid
    left_hand_ind: np.ndarray            # (V_hand,) i32
    right_hand_ind: np.ndarray           # (V_hand,) i32
    head_center: np.ndarray              # (3,)
    left_hand_center: np.ndarray         # (3,)
    right_hand_center: np.ndarray        # (3,)
    texcoords: np.ndarray | None = None          # (T, 2) f32, image-space v
    faces_uv_idx: np.ndarray | None = None       # (F, 3) i32: face -> texcoord ids
    uvmap_f_idx: np.ndarray | None = None        # (U, U) i32, -1 = empty
    uvmap_f_bary: np.ndarray | None = None       # (U, U, 3) f32
    uvmap_mask: np.ndarray | None = None         # (U, U) bool
    vertex_uv_coord: np.ndarray | None = None    # (V, 2) f32


# ---------------------------------------------------------------------------
# OBJ / UV utilities
# ---------------------------------------------------------------------------


def parse_obj_uv(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse an OBJ with `vt` records and `f v/vt` faces.

    Returns (verts (V,3), texcoords (T,2), faces_v (F,3), faces_vt (F,3))."""
    verts, texcoords, faces_v, faces_vt = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                texcoords.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                fv, fvt = [], []
                for tok in line.split()[1:4]:
                    parts = tok.split("/")
                    fv.append(int(parts[0]) - 1)
                    fvt.append(int(parts[1]) - 1 if len(parts) > 1 and parts[1] else 0)
                faces_v.append(fv)
                faces_vt.append(fvt)
    return (
        np.asarray(verts, np.float32),
        np.asarray(texcoords, np.float32),
        np.asarray(faces_v, np.int32),
        np.asarray(faces_vt, np.int32),
    )


def _clip_lines(W: int, H: int, x1, y1, x2, y2):
    """OpenCV's `clipLine` on arrays of integer segments: the Cohen-Sutherland
    walk with its double-precision, truncated intersections, the second end
    clipped against the first end's clipped position.

    Returns (ok, x1, y1, x2, y2); ok is False where the segment misses the
    W x H image (the coordinates are then not meaningful)."""
    right, bottom = W - 1, H - 1

    def code(x, y, with_y=True):
        c = (x < 0).astype(np.int64) + (x > right) * 2
        return c + (y < 0) * 4 + (y > bottom) * 8 if with_y else c

    def moved(base, a, num, den, sel):
        # base + (int64)((double)a * num / den), only where sel
        den = np.where(sel, den, 1).astype(np.float64)
        step = np.trunc(a.astype(np.float64) * num.astype(np.float64) / den)
        return np.where(sel, base + np.where(sel, step, 0).astype(np.int64), base)

    c1, c2 = code(x1, y1), code(x2, y2)
    act = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = act & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = moved(x1, a - y1, x2 - x1, y2 - y1, s)
    y1 = np.where(s, a, y1)
    c1 = np.where(s, code(x1, y1, False), c1)
    s = act & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = moved(x2, a - y2, x2 - x1, y2 - y1, s)
    y2 = np.where(s, a, y2)
    c2 = np.where(s, code(x2, y2, False), c2)
    act = act & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = act & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = moved(y1, a - x1, y2 - y1, x2 - x1, s)
    x1 = np.where(s, a, x1)
    c1 = np.where(s, 0, c1)
    s = act & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = moved(y2, a - x2, y2 - y1, x2 - x1, s)
    x2 = np.where(s, a, x2)
    c2 = np.where(s, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _ramps(n: np.ndarray) -> np.ndarray:
    """0, 1, .., n[0]-1, 0, 1, .., n[1]-1, ...: each run's position in it."""
    return np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)


def _line_pixels(W: int, H: int, x1, y1, x2, y2):
    """Pixels of OpenCV's 8-connected `line` for each segment (its
    LineIterator: clipped to the image, walked left to right, Bresenham's
    error term in closed form). Returns (segment index, y, x)."""
    inside = ((x1 >= 0) & (x1 < W) & (x2 >= 0) & (x2 < W)
              & (y1 >= 0) & (y1 < H) & (y2 >= 0) & (y2 < H))
    ok, cx1, cy1, cx2, cy2 = _clip_lines(W, H, x1, y1, x2, y2)
    keep = np.nonzero(inside | ok)[0]
    x1, y1, x2, y2 = cx1[keep], cy1[keep], cx2[keep], cy2[keep]
    swap = x2 < x1
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    count = major + 1
    seg = np.repeat(np.arange(len(keep)), count)
    i = _ramps(count)
    mj, mn = major[seg], minor[seg]
    # minor steps taken before pixel i: ceil((2*minor*i - major) / (2*major)), >= 0
    m = np.where(mj > 0, -((mj - 2 * mn * i) // np.maximum(2 * mj, 1)), 0)
    m = np.maximum(m, 0)
    v = vert[seg]
    x = x1[seg] + np.where(v, m, i)
    y = y1[seg] + sy[seg] * np.where(v, i, m)
    return keep[seg], y, x


_FAR = 1 << 40


def _polygon_fill(tri: np.ndarray, W: int, H: int):
    """Pixels of OpenCV's filled contour for each triangle (F, 3, 2) int64
    (x, y), in integer arithmetic. Returns (triangle index, y, x).

    Equal to `cv2.drawContours(img, [tri], 0, c, -1)` (OpenCV 5): the three
    edges' lines, plus on each row y the pixels x with xl - 1/2 < x <
    xr + 1/2 between the two edges crossing it (each edge over [y_top,
    y_bottom)). An edge that leaves the image is taken along its clipped
    line; on its rows outside that line it lies beyond the border it
    crossed, and a line clipped to one point stands at that point's x."""
    F = tri.shape[0]
    p0 = tri[:, [2, 0, 1]].reshape(-1, 2)          # contour edges v[i-1] -> v[i]
    p1 = tri.reshape(-1, 2)
    eface = np.repeat(np.arange(F), 3)
    lseg, ly, lx = _line_pixels(W, H, p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1])

    xa, ya, xb, yb = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
    inside = (xa >= 0) & (xa < W) & (xb >= 0) & (xb < W) & (ya >= 0) & (ya < H) & \
        (yb >= 0) & (yb < H)
    ok, cxa, cya, cxb, cyb = _clip_lines(W, H, xa, ya, xb, yb)
    # orient every edge top -> bottom (the clipped ends follow their originals)
    flip = ya > yb
    xa, xb = np.where(flip, xb, xa), np.where(flip, xa, xb)
    ya, yb = np.where(flip, yb, ya), np.where(flip, ya, yb)
    cxa, cxb = np.where(flip, cxb, cxa), np.where(flip, cxa, cxb)
    cya, cyb = np.where(flip, cyb, cya), np.where(flip, cya, cyb)
    clipped = ~inside & ok
    point = clipped & (cya == cyb)
    seg = clipped & ~point
    # the line each edge follows: (sx0, sy0) -> (sx1, sy1)
    sx0 = np.where(seg | point, cxa, xa)
    sx1 = np.where(seg | point, cxb, xb)
    sy0 = np.where(seg, cya, ya)
    sy1 = np.where(seg, cyb, yb)

    def beyond(x_orig, x_clip):
        return np.where(seg & (x_orig > W - 1) & (x_clip == W - 1), 1,
                        np.where(seg & (x_orig < 0) & (x_clip == 0), -1, 0))

    side_top, side_bot = beyond(xa, cxa), beyond(xb, cxb)

    live = (ya != yb).reshape(F, 3)
    e_y0, e_y1 = ya.reshape(F, 3), yb.reshape(F, 3)
    y_lo = np.where(live, e_y0, np.iinfo(np.int64).max).min(1)
    y_hi = np.where(live, e_y1, np.iinfo(np.int64).min).max(1)
    has = live.sum(1) >= 2
    r0 = np.maximum(y_lo, 0)
    nrow = np.where(has, np.minimum(y_hi, H) - r0, 0).clip(min=0)
    rf = np.repeat(np.arange(F), nrow)
    ry = r0[rf] + _ramps(nrow)

    lo = np.full(len(rf), _FAR, np.int64)
    hi = np.full(len(rf), -_FAR, np.int64)
    for k in range(3):
        e = rf * 3 + k
        act = live[rf, k] & (e_y0[rf, k] <= ry) & (ry < e_y1[rf, k])
        num, den = sx1[e] - sx0[e], sy1[e] - sy0[e]
        neg = den < 0
        num, den = np.where(neg, -num, num), np.where(neg, -den, den)
        den = np.where(den == 0, 1, den)
        # x + 1/2 = n / (2 den): left end floor, right end ceil - 1
        n = 2 * sx0[e] * den + 2 * (ry - sy0[e]) * num + den
        left, right = n // (2 * den), -((-n) // (2 * den)) - 1
        for side, rows in ((side_top[e], ry < sy0[e]), (side_bot[e], ry >= sy1[e])):
            far = (side != 0) & rows
            left = np.where(far, side * _FAR, left)
            right = np.where(far, side * _FAR, right)
        lo = np.where(act, np.minimum(lo, left), lo)
        hi = np.where(act, np.maximum(hi, right), hi)

    draw = (lo < W) & (hi >= 0)
    x1, x2 = np.maximum(lo, 0)[draw], np.minimum(hi, W - 1)[draw]
    sf, sy_ = rf[draw], ry[draw]
    n = np.maximum(x2 - x1 + 1, 0)
    pf = np.repeat(sf, n)
    py = np.repeat(sy_, n)
    px = np.repeat(x1, n) + _ramps(n)
    return (np.concatenate([eface[lseg], pf]), np.concatenate([ly, py]),
            np.concatenate([lx, px]))


def uv_face_tables(
    texcoords: np.ndarray,
    faces_vt: np.ndarray,
    uv_size: int = 512,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-texel face id + barycentrics for the UV chart.

    Vertex coords are round(uv * uv_size) integers; each face is filled as
    OpenCV's filled contour fills it (`_polygon_fill`), in face order, so a
    later face overwrites an earlier one. Barycentrics are the absolute
    sub-triangle areas at the integer texel, over their sum + 1e-6.

    Returns (face_idx (U,U) i32 with -1 empty, bary (U,U,3) f32, mask (U,U) bool).
    """
    U = uv_size
    uvc = np.round(texcoords * U).astype(np.int32)
    face_idx = np.full((U, U), -1, np.int32)
    if len(faces_vt):
        f, y, x = _polygon_fill(uvc[faces_vt].astype(np.int64), U, U)
        np.maximum.at(face_idx, (y, x), f.astype(np.int32))
    mask = face_idx >= 0

    bary_map = np.zeros((U, U, 3), np.float32)
    yy, xx = np.nonzero(mask)
    tri = uvc[faces_vt[face_idx[yy, xx]]].astype(np.float64)  # (N, 3, 2)
    p = np.stack([xx, yy], axis=-1).astype(np.float64)
    c0, c1, c2 = p - tri[:, 0], p - tri[:, 1], p - tri[:, 2]

    def cross(a, b):
        return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

    a0 = 0.5 * np.abs(cross(c1, c2))
    a1 = 0.5 * np.abs(cross(c0, c2))
    a2 = 0.5 * np.abs(cross(c0, c1))
    total = a0 + a1 + a2 + 1e-6
    bary_map[yy, xx, 0] = (a0 / total).astype(np.float32)
    bary_map[yy, xx, 1] = (a1 / total).astype(np.float32)
    bary_map[yy, xx, 2] = (a2 / total).astype(np.float32)
    return face_idx, bary_map, mask


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


def template_position_map(
    v_template: np.ndarray,
    faces: np.ndarray,
    uvmap_f_idx: np.ndarray,
    uvmap_mask: np.ndarray,
) -> np.ndarray:
    """UV-space template position map: each valid texel holds the centroid of
    its bound face's three template vertices. Returns (U, U, 3) f32, zeros
    outside the chart."""
    U = uvmap_f_idx.shape[0]
    fid = np.where(uvmap_mask, uvmap_f_idx, 0)
    tri = v_template[faces[fid.reshape(-1)]]          # (U*U, 3, 3)
    pos = tri.mean(axis=1).reshape(U, U, 3).astype(np.float32)
    return pos * uvmap_mask[..., None]


# ---------------------------------------------------------------------------
# pickles without chumpy
# ---------------------------------------------------------------------------


class ChumpyArray:
    """Stand-in for chumpy's `Ch` in a pickle: keeps the pickled state; the
    array is the state's `x`, the value chumpy keeps for a leaf array."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self) -> np.ndarray:
        return np.asarray(self.__dict__["x"])


_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")
_SPARSE_NAMES = ("csc_matrix", "csr_matrix")


class AssetUnpickler(pickle.Unpickler):
    """Unpickler for the SMPL-X/FLAME asset pickles: numpy arrays and dtypes,
    `scipy.sparse` matrices, chumpy's `Ch` as `ChumpyArray`, sets (in chumpy's
    pickled state) and the object and bytes reconstructors of protocol 2.
    Any other class is refused by its module and name."""

    def find_class(self, module, name):
        if module.split(".")[0] == "chumpy" and name == "Ch":
            return ChumpyArray
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module.startswith("scipy.sparse") and name in _SPARSE_NAMES:
            return super().find_class(module, name)
        if (module, name) in (("copy_reg", "_reconstructor"), ("copyreg", "_reconstructor")):
            return copyreg._reconstructor
        if module in ("__builtin__", "builtins") and name in ("object", "set", "frozenset"):
            return {"object": object, "set": set, "frozenset": frozenset}[name]
        if (module, name) == ("_codecs", "encode"):   # bytes in a protocol-2 pickle
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused pickled class {module}.{name}")


def load_asset_pickle(path: str):
    with open(path, "rb") as f:
        return AssetUnpickler(f, encoding="latin1").load()


def _as_array(x) -> np.ndarray:
    """Pickled value -> dense numpy array (sparse densified, chumpy unwrapped)."""
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    if isinstance(x, ChumpyArray):
        x = x.r
    return np.asarray(x)


# ---------------------------------------------------------------------------
# real-asset loaders
# ---------------------------------------------------------------------------


def _require(path: str, what: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing — {what}")
    return path


def load_smplx(
    assets_dir: str,
    n_shape: int = 300,
    n_exp: int = 50,
    add_teeth: bool = True,
    uv_size: int = 512,
    flame_assets_dir: str | None = None,
) -> tuple[ParametricModelData, SmplxExtras]:
    """Load the SMPL-X 2020 neutral model and its auxiliary assets.

    Reads SMPLX_NEUTRAL_2020.npz (obtain per the upstream instructions; not
    redistributable), SMPL-X__FLAME_vertex_ids.npy, MANO_SMPLX_vertex_ids.pkl,
    the optional FLAME eyelid deltas and smplx_uv.obj, grafts the teeth and
    builds the UV tables."""
    model_path = _require(os.path.join(assets_dir, "SMPLX_NEUTRAL_2020.npz"),
                          "download SMPL-X 2020 per upstream instructions")
    ss = np.load(model_path, allow_pickle=True)
    shapedirs_full = np.asarray(ss["shapedirs"], np.float32)
    shapedirs = np.concatenate(
        [shapedirs_full[:, :, :n_shape], shapedirs_full[:, :, 300 : 300 + n_exp]], axis=2
    )
    parents = np.asarray(ss["kintree_table"][0], np.int64).astype(np.int32)
    parents[0] = -1

    data = ParametricModelData(
        name="smplx",
        v_template=np.asarray(ss["v_template"], np.float32),
        faces=np.asarray(ss["f"], np.int64).astype(np.int32),
        shapedirs=shapedirs,
        posedirs=np.asarray(ss["posedirs"], np.float32),
        J_regressor=np.asarray(ss["J_regressor"], np.float32),
        parents=parents,
        lbs_weights=np.asarray(ss["weights"], np.float32),
        n_shape=n_shape,
        n_exp=n_exp,
        lmk_faces_idx=np.asarray(ss["lmk_faces_idx"], np.int64).astype(np.int32)
        if "lmk_faces_idx" in ss
        else None,
        lmk_bary_coords=np.asarray(ss["lmk_bary_coords"], np.float32)
        if "lmk_bary_coords" in ss
        else None,
    )

    smplx2flame_ind = np.load(_require(
        os.path.join(assets_dir, "SMPL-X__FLAME_vertex_ids.npy"),
        "the SMPL-X/FLAME vertex map ships with the SMPL-X assets")).astype(np.int32)
    mano_ids = load_asset_pickle(_require(
        os.path.join(assets_dir, "MANO_SMPLX_vertex_ids.pkl"),
        "the MANO hand vertex ids ship with the SMPL-X assets"))

    V = data.num_vertices
    l_eyelid = np.zeros((V, 3), np.float32)
    r_eyelid = np.zeros((V, 3), np.float32)
    l_path = os.path.join(assets_dir, "flame_l_eyelid.npy")
    if os.path.exists(l_path):
        l_eyelid[smplx2flame_ind] = np.load(l_path).reshape(-1, 3)
        r_eyelid[smplx2flame_ind] = np.load(_require(
            os.path.join(assets_dir, "flame_r_eyelid.npy"),
            "flame_l_eyelid.npy has no right-eye counterpart")).reshape(-1, 3)
    data = dataclasses.replace(data, l_eyelid=l_eyelid, r_eyelid=r_eyelid)

    _, texcoords, _, faces_vt = parse_obj_uv(_require(
        os.path.join(assets_dir, "smplx_uv.obj"), "the SMPL-X UV chart ships with the "
        "SMPL-X assets"))
    texcoords = texcoords.copy()
    texcoords[:, 1] = 1.0 - texcoords[:, 1]  # to image space

    lh = np.asarray(mano_ids["left_hand"])
    rh = np.asarray(mano_ids["right_hand"])
    extras = SmplxExtras(
        smplx2flame_ind=smplx2flame_ind,
        left_hand_ind=np.asarray(lh, np.int32),
        right_hand_ind=np.asarray(rh, np.int32),
        head_center=data.v_template[smplx2flame_ind].mean(0),
        left_hand_center=data.v_template[lh].mean(0),
        right_hand_center=data.v_template[rh].mean(0),
        texcoords=texcoords,
        faces_uv_idx=faces_vt,
    )

    if add_teeth:
        from .teeth import graft_teeth

        lip_ids = _flame_lip_rings(flame_assets_dir or _sibling(assets_dir, "FLAME"))
        data, extras = graft_teeth(data, extras, lip_ids)

    fidx, fbary, fmask = uv_face_tables(extras.texcoords, extras.faces_uv_idx, uv_size)
    extras = dataclasses.replace(
        extras,
        uvmap_f_idx=fidx,
        uvmap_f_bary=fbary,
        uvmap_mask=fmask,
        vertex_uv_coord=vertex_uv_from_chart(
            data.num_vertices, data.faces, extras.faces_uv_idx, extras.texcoords
        ),
    )
    return data, extras


def _sibling(assets_dir: str, name: str) -> str:
    return os.path.join(os.path.dirname(os.path.normpath(assets_dir)), name)


def _flame_lip_rings(flame_assets_dir: str) -> dict[str, np.ndarray]:
    """Lip outside-ring vertex ids (FLAME 2020 topology constants)."""
    del flame_assets_dir  # the rings are topology constants, not a loaded asset
    from .flame_regions import LIP_OUTSIDE_RING_LOWER, LIP_OUTSIDE_RING_UPPER

    return {"upper": LIP_OUTSIDE_RING_UPPER, "lower": LIP_OUTSIDE_RING_LOWER}


def load_flame(
    assets_dir: str,
    n_shape: int = 300,
    n_exp: int = 50,
) -> ParametricModelData:
    """Load the FLAME 2020 generic model (generic_model.pkl, obtain per the
    upstream instructions) and its optional eyelid blendshapes, without
    chumpy (`AssetUnpickler`)."""
    ss = load_asset_pickle(_require(os.path.join(assets_dir, "generic_model.pkl"),
                                    "download FLAME 2020 per upstream instructions"))
    shapedirs_full = _as_array(ss["shapedirs"]).astype(np.float32)
    shapedirs = np.concatenate(
        [shapedirs_full[:, :, :n_shape], shapedirs_full[:, :, 300 : 300 + n_exp]], axis=2
    )
    parents = _as_array(ss["kintree_table"])[0].astype(np.int64).astype(np.int32)
    parents[0] = -1

    l_eyelid = r_eyelid = None
    l_path = os.path.join(assets_dir, "l_eyelid.npy")
    if os.path.exists(l_path):
        l_eyelid = np.load(l_path).reshape(-1, 3).astype(np.float32)
        r_eyelid = np.load(_require(
            os.path.join(assets_dir, "r_eyelid.npy"),
            "l_eyelid.npy has no right-eye counterpart")).reshape(-1, 3).astype(np.float32)

    return ParametricModelData(
        name="flame",
        v_template=_as_array(ss["v_template"]).astype(np.float32),
        faces=_as_array(ss["f"]).astype(np.int32),
        shapedirs=shapedirs,
        posedirs=_as_array(ss["posedirs"]).astype(np.float32),
        J_regressor=_as_array(ss["J_regressor"]).astype(np.float32),
        parents=parents,
        lbs_weights=_as_array(ss["weights"]).astype(np.float32),
        n_shape=n_shape,
        n_exp=n_exp,
        l_eyelid=l_eyelid,
        r_eyelid=r_eyelid,
    )
