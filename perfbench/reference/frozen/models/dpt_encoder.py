"""DINO + DPT-style fusion encoder (counterpart of
`guava_renderer_tpu/models/dpt_encoder.py`).

Five intermediate ViT layers: the deepest four feed a DPT pyramid (1x1
projections, resize 4x/2x/1x/0.5x, RGB concat, 3x3 reduce, four
FeatureFusionBlocks), the shallowest a separately projected low-level path.
Outputs f_map1 (UV-branch features), f_map2 (projection-sampling features)
and a global token.

The global token is `tokens[:, 1]` of the last level, the first *patch*
token and not CLS: the reference takes index 0 of DINOv2's CLS-less
intermediate layers, and the trained weights learned through that.

Internally NCHW; submodules carry the flax names. flax ConvTranspose does
not flip its kernel and `nn.ConvTranspose2d` does, so convert.py flips
`resize0`/`resize1` spatially.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv, leaky_relu, resize_bilinear
from .vit import VisionTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = conv(features, features, 3)
        self.Conv_1 = conv(features, features, 3)

    def forward(self, x):
        out = self.Conv_0(F.relu(x))
        return self.Conv_1(F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    """`with_skip=False` is the first block of the path, which fuses
    nothing and so has no `res1`."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res1 = ResidualConvUnit(features)
        self.res2 = ResidualConvUnit(features)
        self.Conv_0 = conv(features, features, 1)

    def forward(self, x, skip=None, size=None):
        out = x if skip is None else x + self.res1(skip)
        out = self.res2(out)
        if size is None:
            size = (out.shape[-2] * 2, out.shape[-1] * 2)
        return self.Conv_0(resize_bilinear(out, size, antialias=False))


class DinoDPTEncoder(nn.Module):
    """images (B, 3, H, W) in [0, 1] (H = W = 518 for the GUAVA config) ->
    {'f_map1': (B, out1, S, S), 'f_map2': (B, out2, S, S), 'f_global': (B, D)}."""

    def __init__(self, out_dim_1=32, out_dim_2=128, hidden=256, output_size=512,
                 vit_dim=768, vit_depth=12, vit_heads=12, vit_pos_grid=37,
                 pyramid_dims=(256, 512, 1024, 1024)):
        super().__init__()
        self.output_size = output_size
        self.dino = VisionTransformer(dim=vit_dim, depth=vit_depth, num_heads=vit_heads,
                                      pos_grid=vit_pos_grid, num_intermediate=5)
        self.dino.requires_grad_(False)      # the backbone is frozen, as in the reference
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        for i, od in enumerate(pyramid_dims):
            self.add_module(f"project{i}", conv(vit_dim, od, 1))
            self.add_module(f"layer_rn{i}", conv(od + 3, hidden, 3, bias=False))
            self.add_module(f"refine{i}", FeatureFusionBlock(hidden, with_skip=i > 0))
        self.resize0 = nn.ConvTranspose2d(pyramid_dims[0], pyramid_dims[0], 4, stride=4)
        self.resize1 = nn.ConvTranspose2d(pyramid_dims[1], pyramid_dims[1], 2, stride=2)
        self.resize3 = conv(pyramid_dims[3], pyramid_dims[3], 3, stride=2)
        self.project_l0 = conv(vit_dim, hidden, 3, bias=False)
        self.project_l1 = conv(hidden, hidden // 2, 3, bias=False)
        self.fuse_l0 = conv(hidden + 3 + hidden // 2, hidden, 3, bias=False)
        self.fuse_l1 = conv(hidden, hidden, 3, bias=False)
        self.skip_l = conv(hidden + 3, hidden, 3, bias=False)
        self.output_conv = conv(hidden, out_dim_1, 3)
        self.output_conv_2 = conv(hidden, out_dim_2, 3)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        B, _, H, W = images.shape
        gh, gw = H // 14, W // 14
        x = (images - self.mean) / self.std
        with torch.no_grad():
            low_level, *levels = self.dino(x)     # low = 8th block; levels = last 4
        f_global = levels[-1][:, 1]           # first patch token, see the module note

        def grid(tok):                        # (B, 1 + N, D) -> (B, D, gh, gw)
            return tok[:, 1:].transpose(1, 2).reshape(B, -1, gh, gw)

        resizers = {0: self.resize0, 1: self.resize1, 3: self.resize3}
        feats = []
        for i, tok in enumerate(levels):
            f = getattr(self, f"project{i}")(grid(tok))
            if i in resizers:
                f = resizers[i](f)
            rgb = resize_bilinear(x, f.shape[-2:])
            feats.append(getattr(self, f"layer_rn{i}")(torch.cat([rgb, f], dim=1)))

        path = self.refine0(feats[3], size=feats[2].shape[-2:])
        path = self.refine1(path, feats[2], size=feats[1].shape[-2:])
        path = self.refine2(path, feats[1], size=feats[0].shape[-2:])
        path = self.refine3(path, feats[0])

        S = self.output_size
        path = resize_bilinear(path, (S, S), antialias=False)
        image_l = resize_bilinear(x, (S, S), antialias=False)

        low = resize_bilinear(grid(low_level), (gh * 2, gw * 2), align_corners=True)
        low = self.project_l0(low)
        low = resize_bilinear(low, (low.shape[-2] * 4, low.shape[-1] * 4), align_corners=True)
        low = self.project_l1(low)
        low = resize_bilinear(low, (S, S), antialias=False)

        path = torch.cat([path, image_l], dim=1)
        fused = self.fuse_l0(torch.cat([path, low], dim=1))
        fused = self.fuse_l1(leaky_relu(fused, 0.01))
        path = fused + self.skip_l(path)
        return {"f_map1": self.output_conv(path), "f_map2": self.output_conv_2(path),
                "f_global": f_global}
