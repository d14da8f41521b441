"""Gaussian renderer + neural refiner (counterpart of
`guava_renderer_tpu/avatar/renderer.py`).

Rasterize the deformed Gaussian set per batch item (32 channels, colors
precomputed, antialiasing off), take raw RGB = the first 3 channels, and
refine all 32 channels to RGB with StyleUNet-small. Images are NHWC at
this module's surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.cameras import Camera
from ..models.styleunet import StyleUNet
from ..ops.gsplat import RasterizeSettings, rasterize
from .state import GaussianSet


class RenderOutputs(NamedTuple):
    renders: torch.Tensor          # (B, H, W, 3) refined RGB
    raw_renders: torch.Tensor      # (B, H, W, 3) rasterized RGB (channels 0:3)
    feature_renders: torch.Tensor  # (B, H, W, 32)
    radii: torch.Tensor            # (B, P)
    invdepth: torch.Tensor         # (B, H, W)


class NeuralRefiner(nn.Module):
    """StyleUNet-small refiner over NHWC 32-channel feature images."""

    def __init__(self, image_size=512, in_dim=32, out_dim=3, style_dim=512, num_mlp=8,
                 channel_scale=1.0):
        super().__init__()
        self.refiner = StyleUNet(image_size, in_dim, out_dim, style_dim, num_mlp,
                                 channel_scale, small=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.refiner(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GaussianRenderer(nn.Module):
    """Rasterize (kernel K1) + refine; the refiner runs in float32."""

    def __init__(self, refiner: NeuralRefiner, settings: RasterizeSettings = RasterizeSettings()):
        super().__init__()
        self.neural_refiner = refiner
        self.settings = settings

    def forward(self, gaussians: GaussianSet, cam: Camera,
                bg: torch.Tensor | None = None) -> RenderOutputs:
        B = gaussians.xyz.shape[0]
        if bg is None:
            bg = torch.zeros(32, dtype=torch.float32, device=gaussians.xyz.device)
        feats, radii, invds = [], [], []
        for b in range(B):
            color, radius, invd = rasterize(
                gaussians.xyz[b], gaussians.colors[b], gaussians.opacity[b],
                gaussians.scaling[b], gaussians.rotation[b], cam, bg, self.settings,
                channels_first=False)
            feats.append(color)
            radii.append(radius)
            invds.append(invd[..., 0])
        feature_renders = torch.stack(feats)
        return RenderOutputs(
            renders=self.neural_refiner(feature_renders),
            raw_renders=feature_renders[..., :3],
            feature_renders=feature_renders,
            radii=torch.stack(radii),
            invdepth=torch.stack(invds),
        )
