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
