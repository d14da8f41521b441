"""Dense Gaussian rasterizer, the correctness oracle (counterpart of
`guava_renderer_tpu/ops/gsplat_reference.py`).

Evaluates every Gaussian at every pixel in global depth order with the
blending rules of the tile blend: alpha = min(0.99, a * exp(power)),
skipped when power > 0 or alpha < 1/255, a pixel stops once its
transmittance would fall below 1e-4, background blend, expected inverse
depth. Written in differentiable PyTorch ops with no kernel, so autograd
through it is a second gradient reference for `rasterize`. Unlike the blend
kernels it differentiates `min(0.99, .)` as written (zero gradient where
the clamp is active), so scenes that compare gradients keep alpha below it.

O(P * H * W), one Python step a Gaussian: tests and small scenes only.
"""

from __future__ import annotations

import torch

from ..core.cameras import Camera
from ..kernels.blend import ALPHA_MAX, ALPHA_MIN, T_MIN
from .gsplat_project import project_gaussians, tile_rect


def rasterize_reference(means3d, colors, opacities, scales, quats, cam: Camera, bg,
                        scale_modifier: float = 1.0, antialiasing: bool = False,
                        tile: int = 16):
    """-> (color (C, H, W), radii (P,), invdepth (1, H, W)).

    `tile` models the coverage granularity: a Gaussian contributes only to
    pixels of tiles its binning rect overlaps."""
    proj = project_gaussians(means3d, scales, quats, opacities, cam, scale_modifier,
                             antialiasing)
    H, W = cam.height, cam.width
    device = means3d.device
    with torch.no_grad():
        rx0, ry0, rx1, ry1 = tile_rect(proj.mean2d.detach(), proj.radius_bin, W, H, tile)
        inf = torch.full_like(proj.depth, float("inf"))
        order = torch.argsort(torch.where(proj.valid, proj.depth.detach(), inf), stable=True)
        n_valid = int(proj.valid.sum())
        ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                                torch.arange(W, device=device, dtype=torch.float32),
                                indexing="ij")
        tx = torch.floor(xs / tile)
        ty = torch.floor(ys / tile)

    T = torch.ones((H, W), dtype=torch.float32, device=device)
    done = torch.zeros((H, W), dtype=torch.bool, device=device)
    acc = torch.zeros((colors.shape[-1], H, W), dtype=torch.float32, device=device)
    acc_invd = torch.zeros((H, W), dtype=torch.float32, device=device)
    for g in order[:n_valid].tolist():
        d0 = proj.mean2d[g, 0] - xs
        d1 = proj.mean2d[g, 1] - ys
        con = proj.conic[g]
        power = -0.5 * (con[0] * d0 * d0 + con[2] * d1 * d1) - con[1] * d0 * d1
        alpha = torch.clamp(proj.alpha[g] * torch.exp(torch.clamp(power, max=0.0)),
                            max=ALPHA_MAX)
        in_rect = (tx >= rx0[g]) & (tx < rx1[g]) & (ty >= ry0[g]) & (ty < ry1[g])
        contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect & ~done
        would_t = T * (1.0 - alpha)
        dies = contrib & (would_t < T_MIN)
        use = contrib & ~dies
        w = torch.where(use, alpha * T, 0.0)
        acc = acc + w[None] * colors[g][:, None, None]
        acc_invd = acc_invd + w / proj.depth[g]
        T = torch.where(use, would_t, T)
        done = done | dies
    return acc + T[None] * bg[:, None, None], proj.radius, acc_invd[None]
