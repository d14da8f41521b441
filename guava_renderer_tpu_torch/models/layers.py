"""Shared NN building blocks (counterpart of `guava_renderer_tpu/models/layers.py`).

Internally NCHW. Submodule names follow the flax auto-names (`Conv_0`, ...)
so a flax parameter tree maps onto the state dict leaf by leaf (convert.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear 2x upsample; equal to the JAX `resize_bilinear`
    (jax.image semantics) at an exact 2x upscale, where antialiasing is inert."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (F.interpolate(scale=0.5, bilinear, antialias=False) at an
    exact 2x ratio samples at 2o+0.5: the JAX `downsample2x`)."""
    return F.avg_pool2d(x, 2)


def conv(cin: int, cout: int, k: int, bias: bool = True) -> nn.Conv2d:
    """Stride-1 'same' convolution (flax `Conv(cout, (k, k), padding=k//2)`)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class ResBlock(nn.Module):
    """Bilinear up/down residual block."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "down"):
        super().__init__()
        if mode not in ("down", "up"):
            raise ValueError(f"mode must be 'down' or 'up', got {mode!r}")
        self.mode = mode
        self.Conv_0 = conv(in_channels, in_channels, 3)
        self.Conv_1 = conv(in_channels, out_channels, 3)
        self.Conv_2 = conv(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        resample = downsample2x if self.mode == "down" else upsample2x
        out = leaky_relu(self.Conv_0(x))
        out = leaky_relu(self.Conv_1(resample(out)))
        return out + self.Conv_2(resample(x))
