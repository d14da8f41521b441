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
