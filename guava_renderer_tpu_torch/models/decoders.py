"""Gaussian attribute decoders (counterpart of
`guava_renderer_tpu/models/decoders.py`).

* VertexGSDecoder: shared 4-layer MLP trunk, then per-attribute heads
  conditioned on the harmonic-embedded camera direction; the scale head is
  sigmoid * 0.05.
* UVPointGSDecoder: conv trunk + conv heads on the UV feature chart; the
  scale head is exp of the exponent clamped at 8; an extra local_pos head.

Submodules carry the flax names (`trunk{i}`, `color0`, `color1`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv, leaky_relu


class VertexGSDecoder(nn.Module):
    def __init__(self, in_dim=512, dir_dim=27, color_dim=32, scale_max=0.05):
        super().__init__()
        self.scale_max = scale_max
        h = in_dim // 2
        for i in range(4):
            self.add_module(f"trunk{i}", nn.Linear(in_dim if i == 0 else h, h))
        for name, out in (("color", color_dim), ("opacity", 1), ("scale", 3), ("rotation", 4)):
            self.add_module(f"{name}0", nn.Linear(h + dir_dim, 128))
            self.add_module(f"{name}1", nn.Linear(128, out))

    def forward(self, features: torch.Tensor, cam_dirs: torch.Tensor) -> dict:
        """features (B, V, in_dim), cam_dirs (B, dir_dim) -> per-vertex attrs."""
        x = features
        for i in range(4):
            x = getattr(self, f"trunk{i}")(x)
            if i < 3:
                x = F.relu(x)
        x = torch.cat([x, cam_dirs[:, None].expand(-1, x.shape[1], -1)], dim=-1)

        def head(name):
            return getattr(self, f"{name}1")(F.relu(getattr(self, f"{name}0")(x)))

        rot = head("rotation")
        # Normalised over axis 1, the VERTEX axis of (B, V, 4), not the
        # quaternion axis: the reference calls F.normalize with its default
        # dim, the trained weights learned through it, and the deformer
        # renormalises per quaternion only after composing with the
        # deformation, so the skew is part of the model.
        rot = rot / torch.clamp(torch.linalg.norm(rot, dim=1, keepdim=True), min=1e-12)
        return {
            "colors": head("color"),
            "opacities": torch.sigmoid(head("opacity")),
            "scales": torch.sigmoid(head("scale")) * self.scale_max,
            "rotations": rot,
            "static_offsets": None,
        }


class UVPointGSDecoder(nn.Module):
    def __init__(self, in_dim=128, dir_dim=27, color_dim=32):
        super().__init__()
        h1 = max(in_dim, 128)
        h2 = max(in_dim // 2, 64)
        for i in range(3):
            self.add_module(f"trunk{i}", conv(in_dim + dir_dim if i == 0 else h1, h1, 3))
        for name, mid, out in (("color", h1, color_dim), ("opacity", h2, 1), ("scale", h2, 3),
                               ("rotation", h2, 4)):
            self.add_module(f"{name}0", conv(h1, mid, 3))
            self.add_module(f"{name}1", conv(mid, out, 1))
        self.localpos0 = conv(h1, h1, 3)
        self.localpos1 = conv(h1, h2, 3)
        self.localpos2 = conv(h2, 3, 1)

    def forward(self, features: torch.Tensor, cam_dirs: torch.Tensor) -> dict:
        """features (B, in_dim, U, U) NCHW, cam_dirs (B, dir_dim) -> dict of
        (B, U, U, C) maps, channels last as the JAX decoder returns them."""
        B, _, U, _ = features.shape
        x = torch.cat([features, cam_dirs[:, :, None, None].expand(-1, -1, U, U)], dim=1)
        for i in range(3):
            x = getattr(self, f"trunk{i}")(x)
            if i < 2:
                x = leaky_relu(x, 0.01)

        def head2(name):
            return getattr(self, f"{name}1")(leaky_relu(getattr(self, f"{name}0")(x), 0.01))

        rot = head2("rotation")
        rot = rot / torch.clamp(torch.linalg.norm(rot, dim=1, keepdim=True), min=1e-12)
        y = leaky_relu(self.localpos1(leaky_relu(self.localpos0(x), 0.01)), 0.01)
        out = {
            "colors": head2("color"),
            "opacities": torch.sigmoid(head2("opacity")),
            # the exponent is clamped so random weights give finite scales
            "scales": torch.exp(torch.clamp(head2("scale"), max=8.0)),
            "rotations": rot,
            "local_pos": self.localpos2(y),
        }
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
