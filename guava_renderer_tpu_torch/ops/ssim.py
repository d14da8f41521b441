"""SSIM, PSNR and MAE (counterpart of `guava_renderer_tpu/ops/ssim.py`).

SSIM uses the reference's separable 11-tap Gaussian window (sigma 1.5), C1
and C2, and zero-padded convolution: two depthwise `conv2d`s, which the JAX
package leaves to XLA's convolution as well. Images are (B, H, W, C) in
[0, 1]; everything is differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


@functools.lru_cache
def _gauss_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable depthwise Gaussian blur with zero padding; x is (B, C, H, W)."""
    C = x.shape[1]
    w = torch.as_tensor(_gauss_window(window_size), device=x.device, dtype=x.dtype)
    pad = window_size // 2
    x = F.conv2d(x, w.view(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(pad, 0), groups=C)
    return F.conv2d(x, w.view(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, pad), groups=C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """img1, img2 (B, H, W, C) -> the mean SSIM (scalar), or per item (B,)."""
    a = img1.permute(0, 3, 1, 2)
    b = img2.permute(0, 3, 1, 2)
    mu1 = _blur(a, window_size)
    mu2 = _blur(b, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(a * a, window_size) - mu1_sq
    s2 = _blur(b * b, window_size) - mu2_sq
    s12 = _blur(a * b, window_size) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-item PSNR (B,)."""
    mse = ((img1 - img2) ** 2).mean(dim=tuple(range(1, img1.dim())))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def mae(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return (img1 - img2).abs().mean()
