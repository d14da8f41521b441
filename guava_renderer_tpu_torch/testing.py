"""Small synthetic pipeline instances for tests and smoke runs (counterpart
of `guava_renderer_tpu/testing.py`).

`make_tiny_pipeline` is a 64^2 pipeline with the full-size ViT graph on
small shapes; `make_micro_pipeline` is the smallest configuration that still
crosses every boundary of the training step: ViT + DPT encoder, both
decoders, inverse texture mapping, the mesh z-buffer, the Gaussian
rasterizer forward and backward, the StyleUNet refiner, the crop losses and
the optimizer. Inputs come from numpy draws in the JAX fixtures' order, so
both packages see the same batch from the same seed; weights are random
from a seeded `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .avatar.inferer import InfererConfig
from .bodymodel.ehm import EhmModel
from .bodymodel.synthetic import synthetic_ehm
from .device import resolve_device
from .models.styleunet import init_params_
from .ops.gsplat import RasterizeSettings
from .train.losses import LossConfig
from .train.lpips import LPIPS, init_lpips_
from .train.pipeline import PipelineStatics, make_models


class TinyPipeline(NamedTuple):
    statics: PipelineStatics
    lpips: LPIPS | None
    batch: dict
    num_vertices: int


def tree_to_torch(tree, device):
    """A nested dict of numpy arrays -> tensors on `device` (ints stay ints)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(a, device=device,
                           dtype=torch.float32 if a.dtype.kind == "f" else None)


def synthetic_batch(rng: np.random.Generator, batch_size: int, image_size: int,
                    feat_size: int, n_shape: int, n_exp: int, z: float = 6.0) -> dict:
    """A numpy training batch: seeded source and target images, an all-ones
    mask, the camera at distance `z`, small random poses and three crop
    boxes (head: upper middle; hands: the lower corners)."""
    B, s = batch_size, image_size
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    w2c[:, 2, 3] = z

    def params():
        return {
            "shape": (rng.normal(size=(B, n_shape)) * 0.1).astype(np.float32),
            "body_pose": (rng.normal(size=(B, 21, 3)) * 0.05).astype(np.float32),
            "flame_shape": np.zeros((B, n_shape), np.float32),
            "flame_exp": (rng.normal(size=(B, n_exp)) * 0.1).astype(np.float32),
            "flame_jaw": np.zeros((B, 3), np.float32),
        }

    # the draws follow the JAX fixture's order: source image, source
    # parameters, target image, target parameters
    source = {"image": rng.uniform(0, 1, (B, feat_size, feat_size, 3)).astype(np.float32),
              "w2c": w2c, "params": params()}
    target = {
        "image": rng.uniform(0, 1, (B, s, s, 3)).astype(np.float32),
        "mask": np.ones((B, s, s, 1), np.float32),
        "w2c": w2c.copy(),
        "params": params(),
        "boxes": {
            "head_box": np.asarray([[s // 8, s * 7 // 8, 0, s // 2]] * B, np.int32),
            "left_hand_box": np.asarray([[0, s * 3 // 8, s // 2, s]] * B, np.int32),
            "right_hand_box": np.asarray([[s * 5 // 8, s, s // 2, s]] * B, np.int32),
        },
    }
    return {"source": source, "target": target}


def make_tiny_pipeline(batch_size: int = 2, image_size: int = 64, feat_size: int = 70,
                       uv_size: int = 32, seed: int = 0, with_lpips: bool = True,
                       device="cuda") -> TinyPipeline:
    """Small but complete pipeline on synthetic assets."""
    cfg = InfererConfig(
        image_size=image_size, uvmap_size=uv_size, invtanfov=3.0, dino_out_dim=8,
        uv_out_dim=16, smplx_fea_dim=16, prj_out_dim=16, global_vertex_dim=32, uv_base_dim=8,
        style_dim=64, num_mlp=2, channel_scale=8.0)
    return _build_pipeline(cfg, batch_size, feat_size, seed, with_lpips, crop_size=32,
                           synth_kwargs={}, device=device)


def make_micro_pipeline(batch_size: int = 8, seed: int = 0, device="cuda") -> TinyPipeline:
    """32^2 render, 28^2 source image (2x2 ViT tokens), 16^2 UV chart, a
    5-block 64-wide ViT, and the multi-scale L2 stand-in for LPIPS."""
    cfg = InfererConfig(
        image_size=32, uvmap_size=16, invtanfov=3.0, dino_out_dim=4, uv_out_dim=8,
        smplx_fea_dim=8, prj_out_dim=8, global_vertex_dim=16, uv_base_dim=4, style_dim=32,
        num_mlp=2, channel_scale=16.0, vit_dim=64, vit_depth=5, vit_heads=4,
        pyramid_dims=(16, 16, 16, 16))
    return _build_pipeline(cfg, batch_size, 28, seed, False, crop_size=16,
                           synth_kwargs=dict(body_side=12, head_side=6, n_shape=8, n_exp=4),
                           device=device)


def _build_pipeline(cfg: InfererConfig, batch_size: int, feat_size: int, seed: int,
                    with_lpips: bool, crop_size: int, synth_kwargs: dict,
                    device) -> TinyPipeline:
    dev = resolve_device(device)
    smplx, flame_m, extras = synthetic_ehm(uv_size=cfg.uvmap_size, **synth_kwargs)
    ehm = EhmModel.build(smplx, flame_m, extras, device=dev)
    inferer, renderer = make_models(cfg, smplx.num_vertices,
                                    refiner_channel_scale=cfg.channel_scale,
                                    raster_settings=RasterizeSettings(tile=16))
    gen = torch.Generator().manual_seed(seed)
    init_params_(inferer, gen)
    init_params_(renderer, gen)
    lpips = init_lpips_(LPIPS("alex"), gen).to(dev) if with_lpips else None
    statics = PipelineStatics(
        ehm=ehm,
        faces=torch.as_tensor(np.asarray(smplx.faces), dtype=torch.int64, device=dev),
        uvmap_f_idx=torch.as_tensor(np.asarray(extras.uvmap_f_idx), dtype=torch.int64,
                                    device=dev),
        uvmap_f_bary=torch.as_tensor(np.asarray(extras.uvmap_f_bary), dtype=torch.float32,
                                     device=dev),
        uvmap_mask=torch.as_tensor(np.asarray(extras.uvmap_mask), dtype=torch.bool, device=dev),
        inferer=inferer.to(dev),
        renderer=renderer.to(dev),
        loss_cfg=LossConfig(crop_size=crop_size),
        image_size=cfg.image_size,
        invtanfov=cfg.invtanfov,
    )
    batch = synthetic_batch(np.random.default_rng(seed), batch_size, cfg.image_size, feat_size,
                            smplx.n_shape, smplx.n_exp)
    return TinyPipeline(statics, lpips, tree_to_torch(batch, dev), smplx.num_vertices)


# ---- mesh z-buffer edge cases (kernels/meshraster.py, K5) ----

# pixel coordinates of the near-degenerate faces: multiples of 2^-20, so a
# unit lattice determinant is 2^-40 < 1e-12
NEAR_DEGENERATE_STEP = 2.0 ** -20


def zbuffer_scenes(size: int, segment: int, seed: int = 0) -> dict:
    """Pixel-space triangle scenes for the z-buffer's edge cases on a
    size x size image (size a multiple of 32): name -> (tri (F, 3, 2) f32
    pixel xy, tri_z (F, 3) f32 camera depth). Every scene leaves tiles
    empty. Coordinates are multiples of 2^-8 (the near-degenerate faces' of
    2^-20) and depths powers of two, so `pixels_to_world` inverts them
    exactly.

    - collinear_rows: det = 0 faces along pixel rows and columns (their edge
      functions are 0 on their whole row or column, beyond their bounding
      box) and at rows between pixel centres, over larger faces;
    - collinear_diagonal: det = 0 faces on pixel diagonals and anti-diagonals
      (the same trap; XLA's FMA contraction on the CPU decides other pixels
      there, so these stay out of comparisons with the JAX package);
    - near_degenerate: faces at the image origin with det = +-2^-40 (both
      signs; det_safe is +1e-12 for either) and det = 0 exactly;
    - slivers: long faces 2^-8 to 1/4 pixel thick, at every angle;
    - tie_segments: 3 segment + 5 copies of one face in tile 0 (face ids
      first, so their instances are 0, 1, ...), at depth 4 but depth 2 on
      both sides of the first two segment boundaries: the lowest of the
      nearest copies wins across a boundary;
    - deep_tile: 6 segment small faces inside the pixels [8, 16)^2 (one tile
      at tiles 8, 16 and 32), a run many times the segment."""
    rng = np.random.default_rng(seed)

    def q8(v):
        return np.round(np.asarray(v, np.float64) * 256.0) / 256.0

    def background(n):
        centre = rng.uniform(size * 0.1, size * 0.9, (n, 1, 2))
        tri = q8(np.clip(centre + rng.uniform(-size / 6, size / 6, (n, 3, 2)), 0, size - 1))
        return tri, rng.choice([8.0, 16.0], (n, 3))

    def pack(*parts):
        tri = np.concatenate([p[0] for p in parts]).astype(np.float32)
        return tri, np.concatenate([p[1] for p in parts]).astype(np.float32)

    scenes = {}
    lines = []
    for k in range(16):
        length = int(rng.integers(2, 12))
        x0, y0 = (int(v) for v in rng.integers(1, size - length - 1, 2))
        along = np.array([[x0, y0], [x0 + length, y0], [x0 + length / 2, y0]], np.float64)
        if k % 4 == 1:
            along = along[:, ::-1]                  # a column
        elif k % 4 == 2:
            along = along + [0.0, 0.375]            # between pixel rows
        elif k % 4 == 3:
            along = along[[1, 0, 2]]                # the other orientation
        lines.append(along)
    scenes["collinear_rows"] = pack(background(10), (np.stack(lines), np.full((16, 3), 4.0)))

    diag = []
    for k in range(16):
        length = int(rng.integers(2, 12))
        x0, y0 = (int(v) for v in rng.integers(1, size - length - 1, 2))
        if k % 2:
            diag.append([[x0, y0 + length], [x0 + length, y0], [x0 + length / 2, y0 + length / 2]])
        else:
            diag.append([[x0, y0], [x0 + length, y0 + length], [x0 + length / 2, y0 + length / 2]])
    scenes["collinear_diagonal"] = pack(background(10), (np.array(diag, np.float64),
                                                         np.full((16, 3), 4.0)))

    # lattice faces at the origin: edges (41, 40) and (81, 79) give det -1 in
    # lattice units, the swapped order +1, (82, 80) det 0; no edge points along
    # a pixel row, column or diagonal of the image
    q = NEAR_DEGENERATE_STEP
    tiny = []
    for offset in ((0, 0), (1, 0), (0, 1), (2, 3)):
        a = np.array(offset, np.float64)
        for b, c in (((41, 40), (81, 79)), ((81, 79), (41, 40)), ((41, 40), (82, 80))):
            tiny.append(q * np.stack([a, a + b, a + c]))
    scenes["near_degenerate"] = pack(background(6), (np.array(tiny), np.full((len(tiny), 3), 2.0)))

    slivers = []
    for k in range(24):
        a = rng.uniform(size * 0.1, size * 0.9, 2)
        angle = np.pi * k / 24 + rng.uniform(0, 0.01)
        direction = np.array([np.cos(angle), np.sin(angle)])
        b = np.clip(a + rng.uniform(size / 8, size / 3) * direction, 0, size - 1)
        thick = [2.0 ** -8, 2.0 ** -6, 2.0 ** -4, 0.25][k % 4]
        c = (a + b) / 2 + thick * np.array([-direction[1], direction[0]])
        slivers.append(q8(np.stack([a, b, c])))
    scenes["slivers"] = pack(background(6), (np.array(slivers),
                                              rng.choice([2.0, 4.0, 8.0], (24, 3))))

    copies = 3 * segment + 5
    face = np.array([[1.0, 1.0], [6.5, 1.5], [2.0, 6.0]])
    near = np.zeros(copies, bool)
    for boundary in (segment, 2 * segment):
        near[max(boundary - 2, 0):boundary + 2] = True
    ties = (np.broadcast_to(face, (copies, 3, 2)), np.where(near, 2.0, 4.0)[:, None].repeat(3, 1))
    scenes["tie_segments"] = pack(ties, background(6))

    n_deep = 6 * segment
    a = rng.uniform(8, 15, (n_deep, 1, 2))
    deep = q8(np.clip(a + rng.uniform(-1.5, 1.5, (n_deep, 3, 2)), 8, 15.99))
    scenes["deep_tile"] = pack((deep, rng.choice([2.0, 4.0, 8.0, 16.0], (n_deep, 3))),
                               background(4))
    return scenes


def pad_instances(inst_fid: torch.Tensor, ranges: torch.Tensor, front: torch.Tensor,
                  back: torch.Tensor) -> tuple:
    """(inst_fid, ranges) of a z-buffer binning -> the same runs with the
    face ids `front` before the first and `back` after the last, and ranges
    shifted to match: slack that no tile's run holds."""
    padded = torch.cat([front.to(inst_fid), inst_fid, back.to(inst_fid)])
    return padded, (ranges + front.shape[0]).to(ranges.dtype)


def pixels_to_world(tri: np.ndarray, tri_z: np.ndarray, size: int) -> tuple:
    """A scene of `zbuffer_scenes` -> (verts (3F, 3) f32, faces (F, 3) i32),
    each face its own three vertices: x = z ((2 px + 1) / size - 1), the
    inverse of the projection of a size x size camera with identity pose
    and tanfov 1. It projects them back bit for bit where size is 32 or 64
    (the near-degenerate faces' 2^-20 steps need 32): a depth that is a
    power of two divides exactly, and z + 1e-7 rounds to z."""
    z = tri_z.astype(np.float64)[..., None]
    xy = z * ((2.0 * tri.astype(np.float64) + 1.0) / size - 1.0)
    verts = np.concatenate([xy, z], axis=-1).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)


# ---------------------------------------------------------------------------
# SMPL-X / FLAME files in the published schema
# ---------------------------------------------------------------------------

# the published counts: SMPL-X 2020 neutral and FLAME 2020
SCHEMA_COUNTS = {"smplx_vertices": 10475, "smplx_faces": 20908, "flame_vertices": 5023,
                 "flame_faces": 9976, "hand_vertices": 778, "components": 400}
SCHEMA_HEAD_OFFSET = (0.0, 1.0, 0.0)    # the FLAME head's place in the SMPL-X template


def _sheet_layout(V: int, F: int) -> tuple[int, int, np.ndarray]:
    """A grid of nx x ny vertices, V - nx*ny apex vertices (each behind its
    own cell, on 1-4 faces to the cell's corners) and cross-diagonal faces,
    together exactly V vertices and F faces. Returns (nx, ny, faces per apex)."""
    best = None
    for nx in range(2, int(np.sqrt(V)) + 2):
        for ny in range(nx, V // nx + 1):
            cells = (nx - 1) * (ny - 1)
            e, t = V - nx * ny, F - 2 * cells
            if e < 0 or t < e or e > cells or t - 4 * e > 2 * cells:
                continue
            key = (e, ny - nx)
            if best is None or key < best[0]:
                best = (key, nx, ny, e, t)
    if best is None:
        raise ValueError(f"no sheet layout of {V} vertices and {F} faces")
    _, nx, ny, e, t = best
    per = np.full(e, min(4, t // max(e, 1)), np.int64)
    per[: max(0, min(t, 4 * e) - int(per.sum()))] += 1
    return nx, ny, per


def _sheet(V: int, F: int, extent, uv_origin, uv_size, seam_gap: float):
    """A seeded-free procedural sheet of exactly V vertices and F faces in the
    xy plane (the apexes sit behind it, at larger z) and its UV chart in image
    space, split by a seam down the middle column: more texcoords than vertices.

    Returns (verts, faces, texcoords, faces_vt, nx, ny)."""
    nx, ny, per = _sheet_layout(V, F)
    cells = (nx - 1) * (ny - 1)
    jj, ii = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    gx = (jj / (nx - 1) - 0.5) * extent[0]
    gy = (ii / (ny - 1) - 0.5) * extent[1]
    gz = 0.05 * extent[0] * (2 * jj / (nx - 1) - 1) ** 2
    grid = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    ci, cj = np.divmod(np.arange(cells), nx - 1)
    a = ci * nx + cj
    quad = np.stack([a, a + 1, a + nx, a + nx + 1], 1)          # (cells, 4): b00 b01 b10 b11
    faces = [np.stack([quad[:, 0], quad[:, 1], quad[:, 2]], 1),
             np.stack([quad[:, 1], quad[:, 3], quad[:, 2]], 1)]
    e = len(per)
    apex_cell = (np.arange(e) * (cells // max(e, 1))) if e else np.zeros(0, np.int64)
    depth = 0.3 * extent[0] / (nx - 1)
    apex = grid[quad[apex_cell]].mean(1) + np.array([0.0, 0.0, depth])
    ring = ((0, 1), (1, 3), (3, 2), (2, 0))
    for k in range(4):
        sel = np.nonzero(per > k)[0]
        q = quad[apex_cell[sel]]
        faces.append(np.stack([nx * ny + sel, q[:, ring[k][0]], q[:, ring[k][1]]], 1))
    n_cross = F - 2 * cells - int(per.sum())
    cq = quad[np.arange(n_cross // 2 + n_cross % 2)]
    cross = np.concatenate([np.stack([cq[:, 0], cq[:, 1], cq[:, 3]], 1),
                            np.stack([cq[:, 0], cq[:, 3], cq[:, 2]], 1)])[:n_cross]
    faces.append(cross)
    faces = np.concatenate(faces).astype(np.int64)
    verts = np.concatenate([grid, apex]).astype(np.float32)

    # UV: the grid maps onto its island; the seam column gets a second
    # texcoord, used by the cells right of it, which sit seam_gap further right
    mid = (nx - 1) // 2
    tu = uv_origin[0] + jj / (nx - 1) * uv_size[0] + np.where(jj > mid, seam_gap, 0.0)
    tv = uv_origin[1] + ii / (ny - 1) * uv_size[1]
    tex_grid = np.stack([tu, tv], -1).reshape(-1, 2)
    seam_rows = np.arange(ny) * nx + mid
    tex_seam = tex_grid[seam_rows] + np.array([seam_gap, 0.0])
    tex_apex = tex_grid[quad[apex_cell]].mean(1) + np.where(
        (cj[apex_cell] >= mid)[:, None], [seam_gap, 0.0], 0.0)
    texcoords = np.concatenate([tex_grid, tex_apex, tex_seam]).astype(np.float32)
    seam_id = np.full(nx * ny + e, -1, np.int64)
    seam_id[seam_rows] = nx * ny + e + np.arange(ny)
    # a face is right of the seam when its grid corners' mean column is
    face_col = np.where(faces < nx * ny, faces % nx, -1)
    right = np.where(face_col >= 0, face_col, 0).sum(1) / np.maximum((face_col >= 0).sum(1), 1) > mid
    faces_vt = faces.copy()
    on_seam = (seam_id[faces] >= 0) & right[:, None]
    faces_vt[on_seam] = seam_id[faces][on_seam]
    return verts, faces, texcoords, faces_vt.astype(np.int64), nx, ny


def _regressor_rows(verts: np.ndarray, joints: np.ndarray, k: int = 8) -> np.ndarray:
    J = np.zeros((joints.shape[0], verts.shape[0]), np.float32)
    for j in range(joints.shape[0]):
        J[j, np.argsort(((verts - joints[j]) ** 2).sum(-1))[:k]] = 1.0 / k
    return J


def _soft_weights(verts: np.ndarray, joints: np.ndarray, sharp: float) -> np.ndarray:
    w = np.exp(-sharp * ((verts[:, None] - joints[None]) ** 2).sum(-1))
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def write_flame_pickle(path: str, model: dict, chumpy: bool = False) -> None:
    """Write a FLAME model dict as generic_model.pkl (protocol 2). With
    chumpy=True its dense arrays are pickled as chumpy `Ch` objects, through
    a stand-in `chumpy` module that is in sys.modules only while writing."""
    import pickle
    import sys
    import types

    model = dict(model)
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
    try:
        if chumpy:
            ch = types.ModuleType("chumpy.ch")
            Ch = type("Ch", (), {"__module__": "chumpy.ch"})
            ch.Ch = Ch
            pkg = types.ModuleType("chumpy")
            pkg.ch = ch
            sys.modules["chumpy"], sys.modules["chumpy.ch"] = pkg, ch
            for k in ("v_template", "shapedirs", "posedirs", "weights", "J"):
                obj = Ch.__new__(Ch)
                obj.__dict__.update({"x": np.asarray(model[k], np.float64),
                                     "_dirty_vars": set()})
                model[k] = obj
        with open(path, "wb") as f:
            pickle.dump(model, f, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def write_schema_assets(root: str, seed: int = 0, counts: dict | None = None) -> dict:
    """Write SMPL-X and FLAME asset directories in the published schema,
    with procedural, seeded geometry:

    <root>/SMPLX: SMPLX_NEUTRAL_2020.npz (v_template, f, shapedirs (V, 3, 400),
    posedirs (V, 3, 486), a dense J_regressor, weights, kintree_table, the
    static and dynamic landmark tables), SMPL-X__FLAME_vertex_ids.npy,
    MANO_SMPLX_vertex_ids.pkl, flame_{l,r}_eyelid.npy, smplx_uv.obj (a chart
    with seams: more texcoords than vertices);
    <root>/FLAME: generic_model.pkl (shapedirs (V, 3, 400), posedirs (V, 3, 36),
    a scipy-sparse J_regressor), {l,r}_eyelid.npy, landmark_embedding.npy.

    The SMPL-X head region is the FLAME mesh through the id map (at
    SCHEMA_HEAD_OFFSET), with the eye/jaw/neck regressor rows read from it,
    so the EHM graft is near identity; the FLAME lip rings of
    `flame_regions.py` are two adjacent rows of the head sheet. The mesh sits
    in front of a camera at w2c z = 30 with tan(fov/2) = 1/24 (ubody_512).
    `counts` overrides SCHEMA_COUNTS (smaller meshes for narrow tests).

    Returns {"smplx_dir", "flame_dir", "flame_model"} (the pickled FLAME dict)."""
    import os
    import pickle

    import scipy.sparse

    from .bodymodel.flame_regions import LIP_OUTSIDE_RING_LOWER, LIP_OUTSIDE_RING_UPPER
    from .bodymodel.synthetic import SMPLX_PARENTS

    c = dict(SCHEMA_COUNTS, **(counts or {}))
    rng = np.random.default_rng(seed)
    K = c["components"]
    smplx_dir, flame_dir = os.path.join(root, "SMPLX"), os.path.join(root, "FLAME")
    os.makedirs(smplx_dir, exist_ok=True)
    os.makedirs(flame_dir, exist_ok=True)

    # ---- FLAME: a head sheet whose lip rings sit on two adjacent rows ----
    Vf, Ff = c["flame_vertices"], c["flame_faces"]
    hv, hf, htex, hfvt, hnx, hny = _sheet(Vf, Ff, (0.3, 0.3), (0.62, 0.02), (0.36, 0.36),
                                          seam_gap=0.02)
    n_ring = len(LIP_OUTSIDE_RING_UPPER)
    if hnx < n_ring + 2 or hny < 4 or Vf <= max(LIP_OUTSIDE_RING_UPPER.max(),
                                                 LIP_OUTSIDE_RING_LOWER.max()):
        raise ValueError(f"a FLAME sheet of {Vf} vertices cannot hold the lip rings")
    row, col0 = hny // 3, (hnx - n_ring) // 2
    upper_at = (row + 1) * hnx + col0 + np.arange(n_ring)       # sheet order
    lower_at = row * hnx + col0 + np.arange(n_ring)
    fixed = {int(s): int(i) for s, i in zip(np.r_[upper_at, lower_at],
                                            np.r_[LIP_OUTSIDE_RING_UPPER, LIP_OUTSIDE_RING_LOWER])}
    free_ids = iter(sorted(set(range(Vf)) - set(fixed.values())))
    new_id = np.array([fixed[s] if s in fixed else next(free_ids) for s in range(Vf)])
    flame_v = np.zeros_like(hv)
    flame_v[new_id] = hv
    flame_f = new_id[hf]
    flame_joints = np.array([[0.0, -0.1, 0.0], [0.0, -0.05, 0.0], [0.0, 0.0, 0.02],
                             [-0.05, 0.05, 0.0], [0.05, 0.05, 0.0]], np.float32)
    flame_jreg = _regressor_rows(flame_v, flame_joints)
    flame_sd = (rng.normal(size=(Vf, 3, K)) * 0.003).astype(np.float32)
    flame_pd = (rng.normal(size=(Vf, 3, 36)) * 0.0005).astype(np.float32)
    l_eyelid = (rng.normal(size=(Vf, 3)) * 0.01).astype(np.float32)
    r_eyelid = (rng.normal(size=(Vf, 3)) * 0.01).astype(np.float32)
    flame_model = {
        "f": flame_f.astype(np.uint32),
        "v_template": flame_v.astype(np.float64),
        "shapedirs": flame_sd.astype(np.float64),
        "posedirs": flame_pd.astype(np.float64),
        "J_regressor": scipy.sparse.csc_matrix(flame_jreg.astype(np.float64)),
        "weights": _soft_weights(flame_v, flame_joints, 40.0).astype(np.float64),
        "kintree_table": np.array([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
        "J": flame_joints.astype(np.float64),
        "bs_style": "lbs",
        "bs_type": "lrotmin",
    }
    write_flame_pickle(os.path.join(flame_dir, "generic_model.pkl"), flame_model)
    np.save(os.path.join(flame_dir, "l_eyelid.npy"), l_eyelid)
    np.save(os.path.join(flame_dir, "r_eyelid.npy"), r_eyelid)

    def bary(*shape):
        b = rng.uniform(0.05, 1.0, shape + (3,))
        return (b / b.sum(-1, keepdims=True)).astype(np.float32)

    np.save(os.path.join(flame_dir, "landmark_embedding.npy"), {
        "static_lmk_faces_idx": rng.integers(0, Ff, 51).astype(np.int64),
        "static_lmk_bary_coords": bary(51),
        "dynamic_lmk_faces_idx": rng.integers(0, Ff, (79, 17)).astype(np.int64),
        "dynamic_lmk_bary_coords": bary(79, 17),
        "full_lmk_faces_idx": rng.integers(0, Ff, (1, 68)).astype(np.int64),
        "full_lmk_bary_coords": bary(1, 68),
    }, allow_pickle=True)

    # ---- SMPL-X: a body sheet plus the FLAME head, interleaved by a seeded id map ----
    V, F = c["smplx_vertices"], c["smplx_faces"]
    Vb, Fb = V - Vf, F - Ff
    bv, bf, btex, bfvt, _, _ = _sheet(Vb, Fb, (0.8, 1.6), (0.02, 0.0), (0.5, 0.92),
                                      seam_gap=0.03)
    head_ids = np.sort(rng.choice(V, Vf, replace=False))
    body_ids = np.setdiff1d(np.arange(V), head_ids)
    v_template = np.zeros((V, 3), np.float32)
    v_template[body_ids] = bv
    v_template[head_ids] = flame_v + np.asarray(SCHEMA_HEAD_OFFSET, np.float32)
    faces = np.concatenate([body_ids[bf], head_ids[flame_f]])
    texcoords = np.concatenate([btex, htex])
    faces_vt = np.concatenate([bfvt, hfvt + len(btex)])
    order = rng.permutation(F)
    faces, faces_vt = faces[order], faces_vt[order]

    joints = np.zeros((55, 3), np.float32)
    t = np.linspace(-0.8, 0.8, 55)
    joints[:, 0], joints[:, 1] = np.sin(t * 3.0) * 0.3, t
    for jj, fj in ((12, 1), (22, 2), (23, 3), (24, 4)):      # neck, jaw, eyes
        joints[jj] = flame_joints[fj] + np.asarray(SCHEMA_HEAD_OFFSET, np.float32)
    jreg = _regressor_rows(v_template, joints)
    for jj, fj in ((12, 1), (22, 2), (23, 3), (24, 4)):
        jreg[jj] = 0.0
        jreg[jj, head_ids] = flame_jreg[fj]
    shapedirs = (rng.normal(size=(V, 3, K)) * 0.003).astype(np.float32)
    shapedirs[head_ids] = flame_sd
    head_faces = np.nonzero(np.isin(order, np.arange(Fb, F)))[0]
    kintree = np.stack([SMPLX_PARENTS.astype(np.int64), np.arange(55)])
    kintree[0, 0] = 4294967295
    np.savez(
        os.path.join(smplx_dir, "SMPLX_NEUTRAL_2020.npz"),
        v_template=v_template,
        f=faces.astype(np.int32),
        shapedirs=shapedirs,
        posedirs=(rng.normal(size=(V, 3, 54 * 9)) * 0.0002).astype(np.float32),
        J_regressor=jreg,
        weights=_soft_weights(v_template, joints, 20.0),
        kintree_table=kintree,
        lmk_faces_idx=rng.choice(head_faces, 51).astype(np.int64),
        lmk_bary_coords=bary(51),
        dynamic_lmk_faces_idx=rng.choice(head_faces, (79, 17)).astype(np.int64),
        dynamic_lmk_bary_coords=bary(79, 17),
    )
    np.save(os.path.join(smplx_dir, "SMPL-X__FLAME_vertex_ids.npy"), head_ids.astype(np.int64))
    hands = {}
    for side, corner in (("left_hand", (-0.4, -0.8, 0.0)), ("right_hand", (0.4, -0.8, 0.0))):
        d = ((v_template[body_ids] - np.asarray(corner)) ** 2).sum(-1)
        hands[side] = np.sort(body_ids[np.argsort(d, kind="stable")[: c["hand_vertices"]]])
    with open(os.path.join(smplx_dir, "MANO_SMPLX_vertex_ids.pkl"), "wb") as f:
        pickle.dump(hands, f, protocol=2)
    np.save(os.path.join(smplx_dir, "flame_l_eyelid.npy"), l_eyelid)
    np.save(os.path.join(smplx_dir, "flame_r_eyelid.npy"), r_eyelid)
    with open(os.path.join(smplx_dir, "smplx_uv.obj"), "w") as f:
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v_template))
        # OBJ v runs bottom-up: the loader flips it back to image space
        f.write("".join(f"vt {u:.6f} {1.0 - v:.6f}\n" for u, v in texcoords))
        f.write("".join(f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {cc + 1}/{tc + 1}\n"
                        for (a, b, cc), (ta, tb, tc) in zip(faces, faces_vt)))
    return {"smplx_dir": smplx_dir, "flame_dir": flame_dir, "flame_model": flame_model}
