"""Gaussian renderer + neural refiner (counterpart of
`guava_renderer_tpu/avatar/renderer.py`).

Rasterize the deformed Gaussian set per batch item (32 channels, colors
precomputed, antialiasing off), take raw RGB = the first 3 channels, and
refine all 32 channels to RGB with the refiner (StyleUNet, small by
default, or SimpleUNet under a sigmoid). Images are NHWC at this module's
surface.

The renderer's options: `refiner_size`, the resolution the refiner was
trained at (features are resized to it and the RGB back to the raster
size, as `render_motion.py` renders at 720/1080/2048), and
`refiner_dtype`, the refiner's compute dtype (bf16 for serving; the
rasterizer stays float32, and the caller casts the refiner's parameters).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.cameras import Camera
from ..models.layers import resize_bilinear
from ..models.styleunet import SimpleUNet, StyleUNet
from ..ops.gsplat import RasterizeSettings, rasterize
from ..utils.logging_utils import span
from .state import GaussianSet


class RenderOutputs(NamedTuple):
    renders: torch.Tensor          # (B, H, W, 3) refined RGB
    raw_renders: torch.Tensor      # (B, H, W, 3) rasterized RGB (channels 0:3)
    feature_renders: torch.Tensor  # (B, H, W, 32)
    extra_renders: torch.Tensor    # (B, H, W, 3) channels 3:6
    radii: torch.Tensor            # (B, P)
    invdepth: torch.Tensor         # (B, H, W)


class NeuralRefiner(nn.Module):
    """The refiner over NHWC 32-channel feature images: `refiner_type`
    "styleunet" (StyleUNet, `small` by default) or "simpleunet" (SimpleUNet
    under a sigmoid)."""

    def __init__(self, image_size=512, in_dim=32, out_dim=3, style_dim=512, num_mlp=8,
                 channel_scale=1.0, *, small=True, refiner_type="styleunet"):
        super().__init__()
        self.refiner_type = refiner_type
        if refiner_type == "styleunet":
            self.refiner = StyleUNet(image_size, in_dim, out_dim, style_dim, num_mlp,
                                     channel_scale, small=small)
        elif refiner_type == "simpleunet":
            self.refiner = SimpleUNet(image_size, image_size, in_dim, out_dim, channel_scale)
        else:
            raise ValueError(f"unknown refiner_type {refiner_type!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.refiner(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.sigmoid(y) if self.refiner_type == "simpleunet" else y


class GaussianRenderer(nn.Module):
    """Rasterize (kernel K1, backward K3) + refine. `cams` is one camera for
    the whole batch or one per item. With `refiner_size` set and unlike the
    raster size, the refiner runs at `refiner_size` between two bilinear
    resizes; with `refiner_dtype` set, its input is cast to it and its
    output back to float32."""

    def __init__(self, refiner: NeuralRefiner, settings: RasterizeSettings = RasterizeSettings(),
                 refiner_size: int | None = None, refiner_dtype: torch.dtype | None = None):
        super().__init__()
        self.neural_refiner = refiner
        self.settings = settings
        self.refiner_size = refiner_size
        self.refiner_dtype = refiner_dtype

    def refine(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 32) float32 features -> (B, H, W, 3) float32 RGB."""
        H, W = feats.shape[1:3]
        rsize = self.refiner_size or H
        x = feats
        if (rsize, rsize) != (H, W):
            x = resize_bilinear(x.permute(0, 3, 1, 2), (rsize, rsize)).permute(0, 2, 3, 1)
        if self.refiner_dtype is not None:
            x = x.to(self.refiner_dtype)
        with span("guava.refine"):
            rgb = self.neural_refiner(x).float()
        if (rsize, rsize) != (H, W):
            rgb = resize_bilinear(rgb.permute(0, 3, 1, 2), (H, W)).permute(0, 2, 3, 1)
        return rgb

    def forward(self, gaussians: GaussianSet, cams: Camera | list[Camera],
                bg: torch.Tensor | None = None) -> RenderOutputs:
        B = gaussians.xyz.shape[0]
        if isinstance(cams, Camera):
            cams = [cams] * B
        if len(cams) != B:
            raise ValueError(f"{len(cams)} cameras for a batch of {B}")
        if bg is None:
            bg = torch.zeros(32, dtype=torch.float32, device=gaussians.xyz.device)
        feats, radii, invds = [], [], []
        for b in range(B):
            color, radius, invd = rasterize(
                gaussians.xyz[b], gaussians.colors[b], gaussians.opacity[b],
                gaussians.scaling[b], gaussians.rotation[b], cams[b], bg, self.settings,
                channels_first=False)
            feats.append(color)
            radii.append(radius)
            invds.append(invd[..., 0])
        feature_renders = torch.stack(feats)
        return RenderOutputs(
            renders=self.refine(feature_renders),
            raw_renders=feature_renders[..., :3],
            feature_renders=feature_renders,
            extra_renders=feature_renders[..., 3:6],
            radii=torch.stack(radii),
            invdepth=torch.stack(invds),
        )
