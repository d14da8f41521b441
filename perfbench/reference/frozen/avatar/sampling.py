"""Bilinear feature sampling (counterpart of
`guava_renderer_tpu/avatar/sampling.py`): torch `grid_sample` semantics on
NHWC features, align_corners=False, 'border' or 'zeros' padding, written as
four gathers so both packages round alike."""

from __future__ import annotations

import torch


def grid_sample(features: torch.Tensor, coords: torch.Tensor,
                padding: str = "border") -> torch.Tensor:
    """features (B, H, W, C); coords (B, ..., 2) NDC (x, y), any range ->
    (B, ..., C). Each tap's index is clamped into the image; with 'zeros'
    a tap outside it contributes nothing."""
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    B, H, W, C = features.shape
    lead = coords.shape[1:-1]
    xy = coords.reshape(B, -1, 2)
    x = ((xy[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((xy[..., 1] + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = features.reshape(B, H * W, C)

    def gather(xi, yi):
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        if padding == "zeros":
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            vals = vals * inb[..., None]
        return vals

    out = (
        gather(x0i, y0i) * ((1 - wx) * (1 - wy))[..., None]
        + gather(x0i + 1, y0i) * (wx * (1 - wy))[..., None]
        + gather(x0i, y0i + 1) * ((1 - wx) * wy)[..., None]
        + gather(x0i + 1, y0i + 1) * (wx * wy)[..., None]
    )
    return out.reshape((B,) + tuple(lead) + (C,))


def project_to_ndc(points: torch.Tensor, w2c: torch.Tensor, invtanfov: float) -> torch.Tensor:
    """World points (B, ..., 3) -> NDC (B, ..., 3) by the reference's pinhole
    model, cam_xyz * invtanfov / z."""
    B = w2c.shape[0]
    t = w2c[:, :3, 3].reshape((B,) + (1,) * (points.dim() - 2) + (3,))
    p_cam = torch.einsum("bij,b...j->b...i", w2c[:, :3, :3], points) + t
    return p_cam * invtanfov / (p_cam[..., 2:3] + 1e-7)
