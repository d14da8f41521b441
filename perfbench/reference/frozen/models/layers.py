"""Shared NN building blocks (counterpart of `guava_renderer_tpu/models/layers.py`).

Internally NCHW. Submodule names follow the flax auto-names (`Conv_0`, ...)
so a flax parameter tree maps onto the state dict leaf by leaf (convert.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _LeakyReLU(torch.autograd.Function):
    """`F.leaky_relu` whose derivative at exactly 0 is 1, as the JAX
    package's `where(x >= 0, x, slope * x)` has it (PyTorch's own takes the
    slope there). The point matters: with zero biases every background pixel
    of a rendered image and every invalid texel of a UV chart sits at
    exactly 0 through the first convolutions."""

    @staticmethod
    def forward(ctx, x, slope):
        out = F.leaky_relu(x, negative_slope=slope)
        ctx.save_for_backward(out)      # out has x's sign
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.where(out >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, slope)
    return F.leaky_relu(x, negative_slope=slope)


@functools.lru_cache(maxsize=None)
def _halfpix_weights(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear interpolation matrix with
    jax.image.resize semantics: triangle kernel at half-pixel centres,
    widened by the scale on an antialiased downscale, rows normalised,
    samples outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(n_in, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total == 0, 1, total), 0.0)
    in_range = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return (w * in_range[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ac_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense align-corners linear-interpolation matrix (n_out, n_in), float32
    arithmetic throughout."""
    if n_out == 1 or n_in == 1:
        return np.full((n_out, n_in), 1.0 / n_in, np.float32)
    pos = (np.arange(n_out) * (n_in - 1)).astype(np.float32) / np.float32(n_out - 1)
    lo = np.clip(np.floor(pos).astype(np.int32), 0, n_in - 2)
    frac = pos - lo.astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    w[rows, lo] = 1.0 - frac
    w[rows, lo + 1] += frac
    return w


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], align_corners: bool = False,
                    antialias: bool = True) -> torch.Tensor:
    """NCHW bilinear resize as two interpolation-matrix products.

    align_corners=False is half-pixel sampling; `antialias` matters only on
    a downscale (True: the filtered resize of jax.image / torchvision,
    False: F.interpolate's plain taps). align_corners=True is F.interpolate's
    align-corners mode."""
    H, W = x.shape[-2:]
    h, w = size
    if (H, W) == (h, w):
        return x
    if align_corners:
        wy, wx = _ac_weights(H, h), _ac_weights(W, w)
    else:
        wy, wx = _halfpix_weights(H, h, antialias), _halfpix_weights(W, w, antialias)
    wy = torch.as_tensor(wy, dtype=x.dtype, device=x.device)
    wx = torch.as_tensor(wx, dtype=x.dtype, device=x.device)
    x = torch.einsum("bchw,oh->bcow", x, wy)
    return torch.einsum("bchw,ow->bcho", x, wx)


def harmonic_embedding(x: torch.Tensor, n_freqs: int = 4,
                       include_input: bool = True) -> torch.Tensor:
    """[sin(2^0 x) .. sin(2^{n-1} x), cos(..), x] -> dim d * (2 n + 1)
    (pytorch3d HarmonicEmbedding defaults; d=3, n=4 -> 27)."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * freqs[:, None]).flatten(-2)       # (..., n * d)
    parts = [torch.sin(xb), torch.cos(xb)]
    if include_input:
        parts.append(x)
    return torch.cat(parts, dim=-1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear 2x upsample; equal to the JAX `resize_bilinear`
    (jax.image semantics) at an exact 2x upscale, where antialiasing is inert."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (F.interpolate(scale=0.5, bilinear, antialias=False) at an
    exact 2x ratio samples at 2o+0.5: the JAX `downsample2x`)."""
    return F.avg_pool2d(x, 2)


def conv(cin: int, cout: int, k: int, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    """Convolution padded by k//2 (flax `Conv(cout, (k, k), strides, padding=k//2)`)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


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
