"""The training pipeline: inferer -> avatar -> deform -> render -> loss
(counterpart of `guava_renderer_tpu/train/pipeline.py`).

Source batch in, avatar predicted, target pose deformed, rasterized and
refined, `OptimizationLoss` out, packaged as `loss_fn(batch, iteration)`.
The modules hold their own parameters, so no parameter tree is passed.

A batch is {"source": {"image" (B, Hf, Wf, 3), "w2c" (B, 4, 4), "params":
{...}}, "target": {"image" (B, H, W, 3), "mask" (B, H, W, 1), "w2c",
"params", "boxes": {"head_box", "left_hand_box", "right_hand_box": (B, 4)
[left, right, top, bottom]}}} of tensors on the modules' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint

from ..avatar.deformer import deform_avatar
from ..avatar.inferer import InfererConfig, UbodyGaussianInferer, build_avatar
from ..avatar.renderer import GaussianRenderer, NeuralRefiner
from ..bodymodel.ehm import EhmModel
from ..cli.inference import _unpack_params as unpack_params
from ..core.cameras import Camera
from ..models.layers import resize_bilinear
from ..ops.gsplat import RasterizeSettings
from ..utils.logging_utils import span
from .losses import LossConfig, OptimizationLoss
from .lpips import LPIPS


class PipelineStatics(NamedTuple):
    """What the loss function is built from; the modules are trained in place."""

    ehm: EhmModel
    faces: torch.Tensor
    uvmap_f_idx: torch.Tensor
    uvmap_f_bary: torch.Tensor
    uvmap_mask: torch.Tensor
    inferer: UbodyGaussianInferer
    renderer: GaussianRenderer
    loss_cfg: LossConfig
    image_size: int
    invtanfov: float


def make_models(cfg: InfererConfig, num_vertices: int, refiner_channel_scale: float = 1.0,
                raster_settings: RasterizeSettings = RasterizeSettings()):
    """-> (inferer, renderer); the reference uses one style configuration
    for both StyleUNets."""
    inferer = UbodyGaussianInferer(cfg, num_vertices)
    refiner = NeuralRefiner(cfg.image_size, style_dim=cfg.style_dim, num_mlp=cfg.num_mlp,
                            channel_scale=refiner_channel_scale)
    return inferer, GaussianRenderer(refiner, raster_settings)


def forward_pipeline(batch: dict, statics: PipelineStatics):
    """The whole forward path -> (render outputs, avatar, extra). The train
    loss takes the default gather path of the deformer (no plan), as the
    JAX package's does."""
    src, tgt = batch["source"], batch["target"]
    body_s, flame_s = unpack_params(src["params"])
    avatar, extra = build_avatar(
        statics.inferer, statics.ehm, statics.faces, statics.uvmap_f_idx,
        statics.uvmap_f_bary, statics.uvmap_mask, src["image"], src["w2c"], body_s, flame_s,
        image_size=statics.image_size, invtanfov=statics.invtanfov)
    body_t, flame_t = unpack_params(tgt["params"])
    gaussians = deform_avatar(avatar, statics.ehm, statics.faces, body_t, flame_t)
    cams = [Camera.from_w2c(w2c, 1.0 / statics.invtanfov, statics.image_size,
                            statics.image_size) for w2c in tgt["w2c"]]
    return statics.renderer(gaussians, cams), avatar, extra


def multiscale_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cheap stand-in for LPIPS: L2 at full and at quarter resolution."""
    def down4(x):
        x = x.permute(0, 3, 1, 2)
        return resize_bilinear(x, (x.shape[2] // 4, x.shape[3] // 4))

    return ((a - b) ** 2).mean() + ((down4(a) - down4(b)) ** 2).mean()


def make_loss_fn(statics: PipelineStatics, lpips: LPIPS | None, remat: bool = False):
    """-> loss_fn(batch, iteration) -> (loss, metrics).

    `lpips=None` swaps the LPIPS term for `multiscale_l2`. With `remat` the
    forward is recomputed during the backward pass instead of keeping every
    activation (`torch.utils.checkpoint`)."""
    opt_loss = OptimizationLoss(statics.loss_cfg, multiscale_l2 if lpips is None else lpips)

    def fwd(batch):
        outputs, avatar, _ = forward_pipeline(batch, statics)
        return outputs.renders, outputs.raw_renders, avatar.uv_local_xyz, avatar.uv_scales

    def loss_fn(batch, iteration):
        if remat and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(fwd, batch, use_reentrant=False)
        else:
            out = fwd(batch)
        renders, raw_renders, uv_local_xyz, uv_scales = out
        tgt = batch["target"]
        with span("guava.loss"):
            total, metrics = opt_loss(renders, raw_renders, tgt["image"], tgt["mask"],
                                      tgt.get("boxes"), uv_local_xyz, uv_scales, iteration)
        return total, dict(metrics, total=total)

    return loss_fn
