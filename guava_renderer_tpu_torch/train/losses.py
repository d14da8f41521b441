"""Training loss (counterpart of `guava_renderer_tpu/train/losses.py`).

Terms: masked-background L1 + perceptual on the refined and the raw
renders; head and hand crop L1 + perceptual on boxes resampled to a fixed
crop size; the two UV-Gaussian regularisers relu(|local_xyz| - 3) * 0.01 and
|relu(scale - 0.6)| * 1.0. Crops are a differentiable fixed-size bilinear
resample of the box region.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..avatar.sampling import grid_sample


class LossConfig(NamedTuple):
    """The OPTIMIZE section of configs/train/ubody_512.yaml."""

    lambda_l1: float = 1.0
    lambda_perpetual: float = 0.025
    lambda_perpetual_high: float = 0.05
    perpetual_increase_iter: int = 10000
    lambda_head_crop: float = 0.25
    lambda_hand_crop: float = 0.1
    lambda_local_xyz: float = 0.01
    lambda_local_scale: float = 1.0
    threshold_local_xyz: float = 3.0
    threshold_scale: float = 0.6
    mask_renders_until: int = 1000
    crop_size: int = 256
    bg_color: float = 0.0


def crop_resample(images: torch.Tensor, box: torch.Tensor, size: int) -> torch.Tensor:
    """Differentiable box crop + resize: images (B, H, W, C), box (B, 4)
    [left, right, top, bottom] pixels -> (B, size, size, C), as
    F.interpolate(crop, size, bilinear, align_corners=False) samples."""
    B, H, W, _ = images.shape
    l, r, t, b = (box[:, i].to(torch.float32) for i in range(4))
    j = (torch.arange(size, dtype=torch.float32, device=images.device) + 0.5) / size
    xs = l[:, None] + j[None, :] * (r - l)[:, None] - 0.5       # (B, size) source pixels
    ys = t[:, None] + j[None, :] * (b - t)[:, None] - 0.5
    nx = (2.0 * xs + 1.0) / W - 1.0                              # NDC of the full image
    ny = (2.0 * ys + 1.0) / H - 1.0
    grid = torch.stack([nx[:, None, :].expand(B, size, size),
                        ny[:, :, None].expand(B, size, size)], dim=-1)
    return grid_sample(images, grid, padding="border")


class OptimizationLoss:
    """`perceptual_fn` is any callable (x, y) -> scalar on (B, H, W, 3) images."""

    def __init__(self, cfg: LossConfig, perceptual_fn: Callable):
        self.cfg = cfg
        self.perceptual = perceptual_fn

    def __call__(
        self,
        renders: torch.Tensor,               # (B, H, W, 3) refined
        raw_renders: torch.Tensor | None,
        gt_images: torch.Tensor,             # (B, H, W, 3)
        gt_masks: torch.Tensor,              # (B, H, W, 1)
        boxes: dict[str, torch.Tensor] | None,   # head/left_hand/right_hand (B, 4)
        uv_local_xyz: torch.Tensor,          # (B, N, 3)
        uv_scales: torch.Tensor,             # (B, N, 3)
        iter_idx: int,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        cfg = self.cfg
        iter_idx = int(iter_idx)
        lam_p = (cfg.lambda_perpetual_high if iter_idx > cfg.perpetual_increase_iter
                 else cfg.lambda_perpetual)
        gt = gt_images * gt_masks + (1.0 - gt_masks) * cfg.bg_color
        mask_renders = iter_idx < cfg.mask_renders_until

        def masked(x):
            return x * gt_masks + (1.0 - gt_masks) * cfg.bg_color if mask_renders else x

        def box_loss(pred, name):
            crop_gt = crop_resample(gt, boxes[name], cfg.crop_size)
            crop_pred = crop_resample(pred, boxes[name], cfg.crop_size)
            return ((crop_pred - crop_gt).abs().mean() * cfg.lambda_l1
                    + self.perceptual(crop_pred, crop_gt) * lam_p)

        head = boxes is not None and cfg.lambda_head_crop > 0
        hand = boxes is not None and cfg.lambda_hand_crop > 0
        losses: dict[str, torch.Tensor] = {}
        for pred in (renders, raw_renders):
            if pred is None:
                continue
            pred = masked(pred)
            terms = {"image_loss": (pred - gt).abs().mean() * cfg.lambda_l1,
                     "perpetual_loss": self.perceptual(pred, gt) * lam_p}
            if head:
                terms["head_loss"] = box_loss(pred, "head_box") * cfg.lambda_head_crop
            if hand:
                terms["hand_loss"] = (box_loss(pred, "left_hand_box")
                                      + box_loss(pred, "right_hand_box")) * cfg.lambda_hand_crop
            for k, v in terms.items():
                losses[k] = losses[k] + v if k in losses else v

        losses["local_xyz_loss"] = torch.clamp(
            torch.linalg.vector_norm(uv_local_xyz, dim=-1) - cfg.threshold_local_xyz,
            min=0.0).mean() * cfg.lambda_local_xyz
        losses["local_scale_loss"] = torch.linalg.vector_norm(
            torch.clamp(uv_scales - cfg.threshold_scale, min=0.0),
            dim=-1).mean() * cfg.lambda_local_scale
        total = sum(losses.values())
        return total, losses
